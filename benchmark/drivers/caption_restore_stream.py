"""Driver of the `caption_restore_stream` traffic: a closed loop of one
stream of requests that each caption a photo and then restore it with that
caption, both models resident on one card, as the port's web demo serves an
upload (`serving/web_demo.py`: caption, then restore).

The system under test: `captioner.build_caption_agent` with the
configuration's language model (its top-level keys, a
`DeepseekV3Config`), LLaVA-1.5's vision tower and projector (`captioner`
block), the LM's synthetic vocabulary (`captions.CaptionVocab`); SDXL's two
CLIP text towers (`models.clip_text.SDXLTextEncoder`) over the synthetic
SDXL vocabulary; and the restore pipeline exactly as `restore_stream`
builds it. A request: `CaptionAgent.caption` of the photo (the request's
image at every other pixel: the seeded photo before its x2), with the
request's noise seed as its sampling seed; `trim_caption`; the towers; then
`restore_stream`'s restore of the request's image with those embeddings
and zero negatives (the pipeline's own default). The warm request runs a
`warmup_new_tokens` caption and a `warmup_steps` restore.

The configuration's `use_fp8` (or the control's override) stores the
UNet's weights in fp8 and rounds the routed experts to float8_e4m3fn;
the override `experts_fp8` alone rounds only the experts.

The check, once the window has closed: the sampled request (drawn from
the seed) is captioned again on the window's path, with the program's
logits read at the prefill's last position and at every decode step, and
each MoE layer's expert choices (forward hooks in the prefill; on a card
each replay of the captured decode step's static outputs); its caption has
to be the window's, word for word (`caption_words_differ`, limit 0.5, so
that one word fails: the sampling seed is the request's and the path is
deterministic); the program is freed; the plain fp32 references (TF32
off: `reference/`) compute the vision tower and projector on the same
pixels, then one forward of the LM over [the
prompt's embeddings + the program's own tokens], one layer at a time,
teacher-forced on the tokens and on the program's expert choices
(`caption_logits_rel_l2`: with its own top-k the reference reads ~0.30 on
sound bf16 and ~0.40 with fp8 experts, the near-ties that rounding flips
swamping the arithmetic), and the share of (token, MoE layer) pairs whose
expert set differs from the reference's own fp32 top-k
(`caption_routes_differ_pct`, which a routing fault moves); then the
reference text towers encode the window's caption, and `restore_stream`'s
comparison restores the image from those embeddings (`latent_rel_l2`,
`image_mean_levels`, `image_max_levels`).

A trace run adds, after the window: request (A) with the program's
recorder on and no profiler (its spans: `caption.*` times and shares);
request (B), its caption cut to the traffic's `trace_new_tokens`, with
the recorder on under the host and device profiler (the trace summary; the
kernels launched inside the `caption.decode` range, the wide flash
kernel's device time, the `moe.max_expert_load` counter); and the caption
of a third request alone, as long as B's, its decode steps eager under
the same (the kernels launched inside the `moe` and `mla` ranges, which a
replay's kernels are outside).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import captions
import generator
import program_trace
import trace_reader
from drivers import restore_stream as base
from reference import captioner as ref_captioner
from reference import deepseek_v3 as ref_lm

EXPERTS = ("mlp.experts.gate_up_proj", "mlp.experts.down_proj")


def lm_config(cfg: dict):
    from faithdiff_tpu_torch.captioner import DeepseekV3Config

    names = {f.name for f in dataclasses.fields(DeepseekV3Config)}
    return DeepseekV3Config(**{k: v for k, v in cfg.items() if k in names})


def photo(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[::2, ::2])


class Driver(base.Driver):
    # ---------------------------------------------------------------- set-up
    def setup(self):
        from faithdiff_tpu_torch.captioner import CLIPVisionConfig, build_caption_agent
        from faithdiff_tpu_torch.config import CLIPTextConfig
        from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder
        from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer

        cfg, run, dev = self.cfg, self.run, self.device
        cap = cfg["captioner"]
        use_fp8 = run.overrides.get("use_fp8", cfg["use_fp8"])
        self.experts_fp8 = run.overrides.get("experts_fp8", use_fp8)
        self.vocab = captions.CaptionVocab(cfg["vocab_size"], run.seed)
        tmp = tempfile.mkdtemp(prefix="bench_vocab_")
        try:
            captions.write_sdxl_vocab(tmp)
            self.sdxl_tok = SDXLTokenizer(os.path.join(tmp, "tokenizer"),
                                          os.path.join(tmp, "tokenizer_2"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        self.agent = build_caption_agent(
            self.vocab, lm_config(cfg), CLIPVisionConfig(**cap["vision"]), dtype=self.dtype,
            device=dev, init=False)
        for part in ("llama", "vision", "projector"):
            captions.fill_(run.seed, "lm" if part == "llama" else part, getattr(self.agent, part))
        if self.experts_fp8:
            with torch.no_grad():
                for name, p in self.agent.llama.named_parameters():
                    if name.endswith(EXPERTS):
                        p.copy_(p.to(torch.float8_e4m3fn).to(p.dtype))
        self.agent.temperature, self.agent.top_p = cap["temperature"], cap["top_p"]
        self.max_new_tokens = cap["max_new_tokens"]
        with dev:
            self.towers = SDXLTextEncoder(*(CLIPTextConfig(**c) for c in cap["text_encoders"]),
                                          dtype=self.dtype)
        captions.fill_(run.seed, "text_encoders", self.towers)
        self.towers.eval().requires_grad_(False)
        ucfg = cfg["unet"]
        self.zeros = (torch.zeros((1, 77, ucfg["cross_attention_dim"]), device=dev),
                      torch.zeros((1, ucfg["projection_class_embeddings_input_dim"]
                                   - 6 * ucfg["addition_time_embed_dim"]), device=dev))
        # the restore pipeline and its warm-up: `restore_stream`'s, at the
        # traffic's restore sizes, then a short caption
        self.agent.max_new_tokens = self.traffic["warmup_new_tokens"]
        super().setup()
        warm = generator.request_at(self.requests, run.seed, len(self.requests) - 1)
        self._serve(dataclasses.replace(warm, noise_seed=generator.noise_seed(run.seed, -1)),
                    steps=self.traffic["warmup_steps"])
        self.agent.max_new_tokens = self.max_new_tokens
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _geometry(self):
        super()._geometry()
        pre, post = self._prompt_ids()
        vis = self.cfg["captioner"]["vision"]
        image_tokens = (vis["image_size"] // vis["patch_size"]) ** 2
        self.run.geometry["caption_prompt"] = len(pre) + image_tokens + len(post)

    def _prompt_ids(self):
        from faithdiff_tpu_torch.captioner.agent import DEFAULT_QUESTION, build_vicuna_prompt

        pre, post = build_vicuna_prompt(DEFAULT_QUESTION)
        return self.vocab.encode(pre), self.vocab.encode(post, add_special_tokens=False)

    # -------------------------------------------------------------- requests
    def encode(self, text: str):
        """The prompt's embeddings through the program's towers, fp32."""
        ids_1, ids_2 = self.sdxl_tok(text)
        with torch.no_grad():
            pe, pooled = self.towers(torch.from_numpy(ids_1), torch.from_numpy(ids_2))
        return pe.float(), pooled.float()

    def _serve(self, r, steps=None):
        from faithdiff_tpu_torch.training.text_embeds import trim_caption

        caption = self.agent.caption(photo(r.image), seed=r.noise_seed)
        prompt = trim_caption(caption)
        pe, pooled = self.encode(prompt)
        r = dataclasses.replace(r, prompt=pe, pooled=pooled, neg_prompt=self.zeros[0],
                                neg_pooled=self.zeros[1])
        lat, img = self._restore(r, steps=steps)
        return caption, prompt, lat, img

    def request(self, i: int) -> dict:
        r = generator.request_at(self.requests, self.run.seed, i)
        t0 = time.perf_counter()
        if self._hooks:
            self.images.append({"start": self._event(), "unet": []})
        caption, prompt, lat, img = self._serve(r)
        t1 = time.perf_counter()
        return dict(index=i, start=t0, end=t1, pixels=int(img.shape[0] * img.shape[1]),
                    latents=lat.float().cpu(), image=img, caption=caption, prompt=prompt)

    # ------------------------------------------------------------------ trace
    def traced_request(self, i: int) -> dict:
        """Request (A) unprofiled with the recorder on, then request (B)
        under the host and device profiler with the recorder on and a
        caption of `trace_new_tokens` (a whole caption launches ~1.5 M
        kernels: a trace of it takes longer to read than the run), then the
        eager caption of a third (`_eager_ranges`). B gives the trace
        summary (busy time, classes, gaps: a request whose caption is
        short) and the kernels of the `caption.decode` range."""
        if self.device.type != "cuda":
            return {}
        from faithdiff_tpu_torch.utils import profiling

        a = program_trace.unprofiled_request(self.request, i)
        self.agent.max_new_tokens = self.traffic["trace_new_tokens"]
        try:
            with profiling.recording() as rec:
                events, wall = self._profiled(i + 1, host=True)
            spans = rec.take()
            eager = self._eager_ranges(i + 2)
        finally:
            self.agent.max_new_tokens = self.max_new_tokens
            for h in self._hooks:
                h.remove()
            self._hooks = []
        summary = trace_reader.summarise(trace_reader.device_summary(events, wall),
                                         trace_reader.host_summary(events))
        wide = [e for e in events if e.get("cat") == "kernel" and "flash_wide" in e["name"]]
        prefill = program_trace.named(spans, "caption.prefill")
        self.run.program = dict(
            spans=a.get("spans", []), wall_s=a.get("wall_s"),
            caption=dict(decode=program_trace.upcast_kernels(events, "caption.decode"),
                         moe=eager["moe"], mla=eager["mla"],
                         wide_ms=sum(e["dur"] for e in wide) / 1e3, wide_kernels=len(wide),
                         tokens=sum(s["counters"].get("caption.tokens", 0) for s in spans),
                         max_expert_load=sum(s["counters"].get("moe.max_expert_load", 0)
                                             for s in prefill)))
        del events
        print("caption trace: " + str(self.run.program["caption"]), file=sys.stderr)
        return summary

    def _eager_ranges(self, i: int) -> dict:
        """The kernels of the `moe` and `mla` ranges (`upcast_kernels`) of
        request `i`'s caption alone, of the traffic's `trace_new_tokens`,
        its decode steps run eagerly, under the recorder and the host and
        device profiler: a replay's kernels run in no range, so here the
        ranges hold the prefill and every decode step, on the kernels a
        replay runs."""
        from faithdiff_tpu_torch.utils import profiling

        r = generator.request_at(self.requests, self.run.seed, i)
        lm = self.agent.llama
        lm.decode_graph = lambda caches: None
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        try:
            with profiling.recording(), torch.profiler.profile(activities=act) as prof:
                self.agent.caption(photo(r.image), seed=r.noise_seed)
                torch.cuda.synchronize()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            events = trace_reader.load(path)
        finally:
            del lm.decode_graph
            shutil.rmtree(tmp, ignore_errors=True)
        return {leaf: program_trace.upcast_kernels(events, leaf) for leaf in ("moe", "mla")}

    # ------------------------------------------------------------------ check
    def _free_program(self):
        self.agent = self.towers = None
        super()._free_program()

    def _caption_logits(self, image: np.ndarray, seed: int):
        """The program's caption of `image` again, on the path the window
        runs: (logits [new, vocab] at the prefill's last position and each
        decode step, the tokens fed back, each MoE layer's expert choices
        {layer: [tokens, k]}, the caption). The prefill is read by forward
        hooks; where `greedy_generate` replays a captured decode step, each
        replay's static outputs (`logits`, `routes`) and fed token are
        copied out after it (`_Tapped`), and the hooks come off, since a
        replay calls no module; otherwise the hooks read each eager step."""
        lm = self.agent.llama
        rows, fed, routes = [], [], {}
        quiet = []

        def keep(into):
            return lambda m, a, out: None if quiet else into(m, a, out)

        def route(i):
            return keep(lambda m, a, out: routes.setdefault(i, []).append(
                out[0].detach().clone()))

        hooks = [lm.lm_head.register_forward_hook(
                     keep(lambda m, a, out: rows.append(out[:, -1].detach().clone()))),
                 lm.model.embed_tokens.register_forward_hook(
                     keep(lambda m, a, out: fed.append(a[0].detach().reshape(-1).clone())))]
        hooks += [layer.mlp.gate.register_forward_hook(route(i))
                  for i, layer in enumerate(lm.model.layers) if hasattr(layer.mlp, "gate")]
        make = lm.decode_graph

        def tapped(caches):
            quiet.append(True)                 # the capture's own steps
            try:
                graph = make(caches)
            finally:
                quiet.pop()
            if graph is None:
                return None
            for h in hooks:
                h.remove()
            return _Tapped(graph, rows, fed, routes)

        lm.decode_graph = tapped
        try:
            caption = self.agent.caption(image, seed=seed)
        finally:
            del lm.decode_graph
            for h in hooks:
                h.remove()
        tokens = torch.cat(fed[2:]) if len(fed) > 2 else torch.zeros(0, dtype=torch.long)
        routes = {i: torch.cat(r) for i, r in routes.items()}
        return torch.cat(rows).float(), tokens, routes, caption

    def _lm_numbers(self, image: np.ndarray, logits: torch.Tensor, tokens: torch.Tensor,
                    routes: dict) -> dict:
        from faithdiff_tpu_torch.captioner.clip_vision import preprocess_clip_image

        cfg, seed, dev = self.cfg, self.run.seed, self.device
        nets = ref_captioner.build_captioner(cfg, "meta")
        for part in ("vision", "projector"):
            nets[part].to_empty(device=dev)
            captions.fill_(seed, part, nets[part])
        size = cfg["captioner"]["vision"]["image_size"]
        pixels = torch.from_numpy(preprocess_clip_image(image, size, pad_square=True)).to(dev)
        with torch.no_grad():
            feats = nets["projector"](nets["vision"](pixels))[0]
        del nets
        shapes = ref_lm.parameter_shapes(cfg)

        def weight(name):
            return captions.draw(seed, "lm", name, shapes[name], dev).float()

        pre, post = self._prompt_ids()
        table = weight("model.embed_tokens.weight")
        ids = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        embeds = torch.cat([table[ids(pre)], feats, table[ids(post)], table[tokens.to(dev)]])
        del table, feats
        start = len(pre) + feats_len(cfg) + len(post) - 1
        own = {}
        ref = ref_lm.forward(cfg, embeds, weight, rows=range(start, start + logits.shape[0]),
                             routes=routes, seen=own)
        got = logits.to(dev)
        differ = [(routes[i].to(dev).sort(-1).values != own[i].sort(-1).values).any(-1).float()
                  for i in own]
        return {"caption_logits_rel_l2": float((got - ref).norm() / ref.norm()),
                "caption_routes_differ_pct": 100.0 * float(torch.cat(differ).mean())}

    def _reference_embeds(self, prompt: str):
        nets = ref_captioner.build_captioner(self.cfg, "meta")["text_encoders"]
        nets.to_empty(device=self.device)
        captions.fill_(self.run.seed, "text_encoders", nets)
        ids_1, ids_2 = self.sdxl_tok(prompt)
        with torch.no_grad():
            return nets(torch.from_numpy(ids_1).to(self.device),
                        torch.from_numpy(ids_2).to(self.device))

    def check(self) -> dict:
        run = self.run
        done = run.done()
        rng = np.random.default_rng([run.seed % (1 << 63), 0x5EED])
        sample = done[int(rng.integers(len(done)))]
        r = generator.request_at(self.requests, run.seed, sample["index"])
        image = photo(r.image)
        logits, tokens, routes, caption = self._caption_logits(image, r.noise_seed)
        print(f"check: request {sample['index']}, {logits.shape[0]} logit rows",
              file=sys.stderr)
        self._free_program()
        with base._no_tf32():
            numbers = self._lm_numbers(image, logits, tokens, routes)
            numbers["caption_words_differ"] = float(words_differ(caption, sample["caption"]))
            pe, pooled = self._reference_embeds(sample["prompt"])
            r = dataclasses.replace(r, prompt=pe, pooled=pooled,
                                    neg_prompt=torch.zeros_like(pe),
                                    neg_pooled=torch.zeros_like(pooled))
            models = self.reference_models("fp8" if self.cfg["use_fp8"] else "bf16")
            numbers.update(base.compare(models, self.cfg, r, sample["latents"],
                                        sample["image"]))
        return numbers


class _Tapped:
    """A captured decode step whose replays are read: after each, the fed
    token ids, the step's logits and each MoE layer's chosen experts (the
    graph's static outputs) are copied out."""

    def __init__(self, graph, rows: list, fed: list, routes: dict):
        self.graph, self.rows, self.fed, self.routes = graph, rows, fed, routes

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor, row: int) -> torch.Tensor:
        logits = self.graph(tokens, positions, row)
        self.fed.append(tokens.reshape(-1).clone())
        self.rows.append(logits.clone())
        for i, chosen in self.graph.routes.items():
            self.routes.setdefault(i, []).append(chosen.clone())
        return logits


def words_differ(a: str, b: str) -> int:
    """Words of caption `a` that differ from `b`'s at their place, and the
    words one has past the other's end."""
    x, y = a.split(), b.split()
    return sum(p != q for p, q in zip(x, y)) + abs(len(x) - len(y))


def feats_len(cfg: dict) -> int:
    vis = cfg["captioner"]["vision"]
    return (vis["image_size"] // vis["patch_size"]) ** 2
