"""Driver of the `restore_stream` traffic: a closed loop of one stream of
restores through the port's public restore path, as `cli.py restore`
runs it after its host I/O.

The system under test is `faithdiff_tpu_torch.pipelines.build_pipeline`
in the configuration's dtype with the command line's `cli.TILE_CHUNK`
(read from the program, so a retuned chunk is what is measured) and the
configuration's `use_fp8`, loaded with the benchmark's seeded weights. A
request is `FaithDiffPipeline.__call__(..., output_type="latent")` and
then `FaithDiffPipeline.decode(..., output_type="uint8")`.

Spans (trace runs only) are the benchmark's own: CUDA events at the
request's start, in forward pre- and post-hooks on `pipe.unet`, and
around `decode`; the host-traced request adds `record_function` ranges
around the request and each UNet call. Nothing is added inside the
program.

The check, once the window has closed and the program is freed: one
completed request drawn from the seed is restored again by the plain
reference (`reference/`, fp32, TF32 off) from the same weights and
inputs, with the configuration's weight precision applied by the
reference itself. Compared: the final latents (relative L2 gap), and the
program's uint8 image against the reference's whole restore (the mean and
the widest gap in levels).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import generator
import trace_reader
import weights
from reference import restore as ref_restore
from reference.models import build_models

def _port_config(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


class _HostEvent:
    """A CUDA event's interface on the host clock (CPU runs)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.config, run.traffic
        self.device = torch.device(run.device)
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.images = []            # per request: {"start", "unet": [(pre, post)], "dec": (a, b)}
        self._hooks = []
        self._ranges = []
        self._profiling = False
        self.pipe = self.stand_in = None

    # ---------------------------------------------------------------- set-up
    def _event(self):
        ev = (torch.cuda.Event(enable_timing=True) if self.device.type == "cuda"
              else _HostEvent())
        ev.record()
        return ev

    def setup(self):
        from faithdiff_tpu_torch import cli
        from faithdiff_tpu_torch.config import (DenoiseEncoderConfig, PipelineConfig,
                                                SchedulerConfig, UNetConfig, VAEConfig)
        from faithdiff_tpu_torch.pipelines import build_pipeline

        cfg, run = self.cfg, self.run
        use_fp8 = run.overrides.get("use_fp8", cfg["use_fp8"])
        self.tile_chunk = cli.TILE_CHUNK
        self.requests = generator.make_requests(self.traffic, run.seed, self.device)
        self._geometry()
        if "reference_in_place" in run.overrides:
            # a control (`control.py`): the reference at a lower weight
            # precision serves the requests in the program's place
            self.stand_in = self.reference_models(run.overrides["reference_in_place"])
            return
        sds = weights.make_state_dicts(cfg, run.seed, self.device)
        self.pipe = build_pipeline(
            unet_config=_port_config(UNetConfig, cfg["unet"]),
            vae_config=_port_config(VAEConfig, cfg["vae"]),
            denoise_encoder_config=_port_config(DenoiseEncoderConfig, cfg["denoise_encoder"]),
            scheduler_config=_port_config(SchedulerConfig, cfg["scheduler"]),
            pipeline_config=_port_config(PipelineConfig, cfg["pipeline"]),
            unet_state_dict=sds["unet"], vae_state_dict=sds["vae"],
            denoise_encoder_state_dict=sds["denoise_encoder"],
            dtype=self.dtype, device=self.device, tile_chunk=self.tile_chunk,
            use_fp8=use_fp8)
        del sds
        # warm-up: the cell's shapes (encode, the UNet at its call batch,
        # decode) on inputs that no timed request uses
        warm = dataclasses.replace(self.requests[-1], noise_seed=generator.noise_seed(run.seed, -1))
        self._restore(warm, steps=self.traffic["warmup_steps"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _geometry(self):
        p, t = self.cfg["pipeline"], self.traffic
        lh, lw = t["height"] // 8, t["width"] // 8
        k = (min(p["tile_size"] // 8, lh), min(p["tile_size"] // 8, lw))
        tiles = len(ref_restore.tile_offsets(lh, lw, k, p["tile_overlap"]))
        self.run.geometry = dict(height=t["height"], width=t["width"], latent_tile=k,
                                 tiles=tiles, tile_chunk=self.tile_chunk,
                                 steps=p["num_inference_steps"],
                                 prompt_tokens=t["prompt_tokens"])

    # -------------------------------------------------------------- requests
    def _restore(self, r, steps=None):
        if self.stand_in is not None:
            src = torch.from_numpy(np.ascontiguousarray(r.image))
            with _no_tf32():
                lat = ref_restore.denoise(self.stand_in, self.cfg, src, r.prompt, r.pooled,
                                          r.neg_prompt, r.neg_pooled, r.noise_seed)
                img = ref_restore.decode(self.stand_in, self.cfg, lat, src)
            return lat, img.cpu().numpy()
        lat = self.pipe(r.image, r.prompt, r.pooled, r.neg_prompt, r.neg_pooled,
                        seed=r.noise_seed, num_inference_steps=steps,
                        output_type="latent")
        span = self.images[-1] if self._hooks else None
        if span is not None:
            span["dec"] = [self._event()]
        img = self.pipe.decode(lat, r.image, output_type="uint8")
        if span is not None:
            span["dec"].append(self._event())
        return lat, img

    def request(self, i: int) -> dict:
        r = generator.request_at(self.requests, self.run.seed, i)
        t0 = time.perf_counter()
        if self._hooks:
            self.images.append({"start": self._event(), "unet": []})
        lat, img = self._restore(r)
        t1 = time.perf_counter()
        return dict(index=i, start=t0, end=t1, pixels=int(img.shape[0] * img.shape[1]),
                    latents=lat.float().cpu(), image=img)

    # ------------------------------------------------------------------ spans
    def spans_on(self):
        def pre(module, args, kwargs):
            if self._profiling:
                rf = torch.profiler.record_function("bench.unet")
                rf.__enter__()
                self._ranges.append(rf)
            if self.images:
                self.images[-1]["unet"].append([self._event()])

        def post(module, args, kwargs, out):
            if self.images:
                self.images[-1]["unet"][-1].append(self._event())
            if self._ranges:
                self._ranges.pop().__exit__(None, None, None)

        unet = self.pipe.unet
        self._hooks = [unet.register_forward_pre_hook(pre, with_kwargs=True),
                       unet.register_forward_hook(post, with_kwargs=True)]

    def spans_off(self):
        """Read the window's spans into `run.spans` (ms lists) and keep the
        hooks for the traced request."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        s = {"encode_ms": [], "loop_ms": [], "decode_ms": [], "unet_ms": [], "steps": []}
        for im in self.images:
            if not im["unet"] or len(im.get("dec", ())) != 2:
                continue
            calls = im["unet"]
            s["encode_ms"].append(im["start"].elapsed_time(calls[0][0]))
            s["loop_ms"].append(calls[0][0].elapsed_time(calls[-1][1]))
            s["unet_ms"] += [a.elapsed_time(b) for a, b in calls]
            s["decode_ms"].append(im["dec"][0].elapsed_time(im["dec"][1]))
            s["steps"].append(self.cfg["pipeline"]["num_inference_steps"])
        self.run.spans = s
        self.images = []

    def _profiled(self, i: int, host: bool):
        """(trace events, host wall seconds) of request `i` under
        `torch.profiler`: the device's activity, and with `host` the host's
        too, inside a `bench.image` range. The trace file is removed."""
        act = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            act.append(torch.profiler.ProfilerActivity.CPU)
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            self._profiling = host
            with torch.profiler.profile(activities=act) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench.image"):
                    self.request(i)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            self._profiling = False
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            return trace_reader.load(path), wall
        finally:
            self._profiling = False
            shutil.rmtree(tmp, ignore_errors=True)

    def traced_request(self, i: int) -> dict:
        """Two more requests under the profiler (`trace_reader`): one
        tracing the device alone, for its busy time, kernel classes and
        gaps; one tracing the host too, for the launches inside the UNet
        and the host op behind each gap."""
        if self.device.type != "cuda":
            return {}
        try:
            events, wall = self._profiled(i, host=False)
            device = trace_reader.device_summary(events, wall)
            events, _ = self._profiled(i + 1, host=True)
            host = trace_reader.host_summary(events)
            del events
        finally:
            for h in self._hooks:
                h.remove()
            self._hooks = []
        print(f"traced kernels: device trace {device.get('kernels')}, "
              f"host trace {host.get('kernels')}", file=sys.stderr)
        return trace_reader.summarise(device, host)

    # ------------------------------------------------------------------ check
    def _free_program(self):
        self.pipe = self.stand_in = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_models(self, precision: str):
        """The reference's fp32 networks on the device from the seed's
        weights, the UNet's weights rounded as `precision` stores them."""
        models = build_models(self.cfg, "meta")
        sds = weights.make_state_dicts(self.cfg, self.run.seed, self.device)
        for net, m in models.items():
            m.to_empty(device=self.device)
            m.load_state_dict({k: v.float() for k, v in sds[net].items()}, strict=True)
        del sds
        ref_restore.apply_weight_precision(models["unet"], precision)
        return models

    def check(self) -> dict:
        run = self.run
        done = run.done()
        rng = np.random.default_rng([run.seed % (1 << 63), 0x5EED])
        sample = done[int(rng.integers(len(done)))]
        r = generator.request_at(self.requests, run.seed, sample["index"])
        self._free_program()
        with _no_tf32():
            models = self.reference_models("fp8" if self.cfg["use_fp8"] else "bf16")
            return compare(models, self.cfg, r, sample["latents"], sample["image"])


@contextlib.contextmanager
def _no_tf32():
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def compare(models, cfg: dict, r, latents: torch.Tensor, image: np.ndarray) -> dict:
    """The numbers that decide `correct` for one request: the program's
    final latents and uint8 image against the reference's."""
    src = torch.from_numpy(np.ascontiguousarray(r.image))
    ref_lat = ref_restore.denoise(models, cfg, src, r.prompt, r.pooled,
                                  r.neg_prompt, r.neg_pooled, r.noise_seed).cpu()
    lat = latents.float()
    gap = (torch.from_numpy(np.ascontiguousarray(image)).int()
           - ref_restore.decode(models, cfg, ref_lat, src).cpu().int()).abs()
    return {"latent_rel_l2": float((lat - ref_lat).norm() / ref_lat.norm()),
            "image_mean_levels": float(gap.float().mean()),
            "image_max_levels": float(gap.max())}
