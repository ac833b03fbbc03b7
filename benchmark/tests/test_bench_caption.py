"""The caption-then-restore cell (`drivers/caption_restore_stream.py`) on
the CPU at the tiny widths: a whole run through `harness.run_cell` is
correct; its control (the routed experts rounded to fp8) reads far above it
on `caption_logits_rel_l2`; the check reads a replayed decode step's own
outputs (a stand-in for the card's captured step); faults planted in the
language model's routing, cache and replayed step, in the prompt's path,
in the denoising loop and in the answer come out not correct, each by the
cell's own limits, and so does a caption that is not the window's; the
captioner's
weights, vocabularies, work counts and readers. The reference networks
hold the port's parameter names at the published widths."""
import math
import os

import numpy as np
import pytest
import torch

import caption_roofline
import captions
import control
import harness
from reference import captioner as ref_captioner
from reference import deepseek_v3 as ref_lm
from test_bench_control import _altered_answer, _faulty_step, _half_batch

CELL = "caption-restore-1024x1536"
SPEC = harness.load_spec()
HERE = os.path.dirname(os.path.abspath(__file__))
FULL = harness.load_json(os.path.join(harness.BENCH, "configs",
                                      "faithdiff-sdxl-kimivl-a3b-bf16.json"))


def _inputs():
    w, _, _, limits = harness.cell_inputs(SPEC, CELL)
    return (w, harness.load_json(os.path.join(HERE, "tiny_caption_config.json")),
            harness.load_json(os.path.join(HERE, "tiny_caption_traffic.json")), limits)


def _run(seed, **kw):
    result, checks, error = harness.run_cell(CELL, seed, 0.1, False, "cpu", SPEC,
                                             inputs=_inputs(), **kw)
    assert error is None
    return result


def test_a_tiny_run_is_correct_and_reports_the_cells_metrics():
    result = _run(2_415_919_104)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["check"]) == {"caption_logits_rel_l2", "caption_routes_differ_pct",
                                    "caption_words_differ", "latent_rel_l2",
                                    "image_mean_levels", "image_max_levels"}
    assert result["check"]["caption_logits_rel_l2"]["value"] < 1e-4
    assert result["check"]["caption_routes_differ_pct"]["value"] == 0.0
    assert result["check"]["caption_words_differ"]["value"] == 0.0
    # no allocator peak on the CPU, so no `restore_peak_gib`
    assert set(result["metrics"]) == {"restore_mpix_per_s", "setup_s"}


@pytest.mark.parametrize("overrides", [{"experts_fp8": True}, {"use_fp8": True}])
def test_control_reads_far_above_the_program(overrides):
    seed = 424_242
    sound = _run(seed)["check"]["caption_logits_rel_l2"]["value"]
    ctl = _run(seed, overrides=overrides)["check"]["caption_logits_rel_l2"]["value"]
    assert ctl > 1000 * sound and ctl > 1e-2, (sound, ctl)


def test_control_py_gives_the_cell_both_steps_below():
    assert control.control_overrides(FULL) == {"use_fp8": True}


def _biased_weights(monkeypatch):
    """The router weighting the chosen experts by the bias-corrected scores."""
    from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3

    forward = dv3.Router.forward

    def biased(self, x):
        chosen, w = forward(self, x)
        return chosen, w * (1.0 + 20.0 * self.e_score_correction_bias.gather(0, chosen.reshape(-1))
                            .view_as(w).abs())

    monkeypatch.setattr(dv3.Router, "forward", biased)


def _unbiased_choice(monkeypatch):
    """The router picking the top-k of the scores without the correction
    bias."""
    from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3

    forward = dv3.Router.forward

    def unbiased(self, x):
        saved = self.e_score_correction_bias.clone()
        self.e_score_correction_bias.zero_()
        try:
            return forward(self, x)
        finally:
            self.e_score_correction_bias.copy_(saved)

    monkeypatch.setattr(dv3.Router, "forward", unbiased)


def _stale_cache(monkeypatch):
    """A decode step that attends over the cache without its newest row."""
    from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3

    decode = dv3.MLAttention._decode
    monkeypatch.setattr(dv3.MLAttention, "_decode",
                        lambda self, q_nope, q_pe, latent, attn_len: decode(
                            self, q_nope, q_pe, latent, attn_len - 1))


def _no_pooled(monkeypatch):
    """The prompt's pooled embedding lost on its way to the restore."""
    from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder

    forward = SDXLTextEncoder.forward

    def lost(self, ids_1, ids_2):
        pe, pooled = forward(self, ids_1, ids_2)
        return pe, torch.zeros_like(pooled)

    monkeypatch.setattr(SDXLTextEncoder, "forward", lost)


class _StandInStep:
    """On the CPU, a stand-in for the captured decode step that
    `greedy_generate` replays on a card: each call runs the step eagerly,
    and each MoE layer's chosen experts are kept as a replay's static
    outputs are. With `stale_row` the cache row is set by the first call
    only, as a replay whose static row is never refreshed."""

    def __init__(self, model, caches, stale_row=False):
        from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3

        self.model, self.caches, self.stale_row = model, caches, stale_row
        self.row, self.routes = None, {}
        for i, layer in enumerate(model.model.layers):
            if isinstance(layer.mlp, dv3.MoE):
                layer.mlp.gate.register_forward_hook(
                    lambda m, a, out, i=i: self.routes.__setitem__(i, out[0]))

    def __call__(self, tokens, positions, row):
        self.row = self.row if self.stale_row and self.row is not None else row
        logits, _ = self.model(self.model.embed(tokens), positions, self.caches,
                               self.row, self.row)
        return logits[:, -1]


def _graphed(stale_row):
    def plant(monkeypatch):
        from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3

        monkeypatch.setattr(dv3.DeepseekV3ForCausalLM, "decode_graph",
                            lambda self, caches: _StandInStep(self, caches, stale_row))
    return plant


def test_the_check_reads_the_replayed_decode_step(monkeypatch):
    """Where the decode step is replayed, the check reads the replays'
    own outputs: a sound stand-in reads as the eager path does."""
    _graphed(False)(monkeypatch)
    result = _run(2_415_919_104)
    assert result["correct"] is True
    assert result["check"]["caption_logits_rel_l2"]["value"] < 1e-4
    assert result["check"]["caption_routes_differ_pct"]["value"] == 0.0


@pytest.mark.parametrize("fault", [_biased_weights, _unbiased_choice, _stale_cache, _no_pooled,
                                   _altered_answer, _faulty_step, _half_batch, _graphed(True)])
def test_faults_come_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _run(77)
    assert result["correct"] is False
    assert all(math.isfinite(c["value"]) for c in result["check"].values())


def test_a_caption_that_differs_from_the_windows_is_not_correct(monkeypatch):
    """The check's caption has to be the window's, word for word."""
    load = harness.driver

    def driver(name):
        drv = load(name)
        served = drv.Driver._serve

        def other_caption(self, r, steps=None):
            caption, prompt, lat, img = served(self, r, steps)
            return caption + " extra", prompt, lat, img

        drv.Driver._serve = other_caption
        return drv

    monkeypatch.setattr(harness, "driver", driver)
    result = _run(77)
    assert result["correct"] is False
    assert result["check"]["caption_words_differ"]["value"] == 1.0
    assert load("caption_restore_stream").words_differ("a b c", "a x c d") == 2


def test_weights_are_drawn_per_tensor_from_the_seed():
    a = captions.draw(5, "lm", "model.layers.3.mlp.experts.down_proj", (4, 8, 16), "cpu")
    b = captions.draw(5, "lm", "model.layers.3.mlp.experts.down_proj", (4, 8, 16), "cpu")
    c = captions.draw(5, "lm", "model.layers.4.mlp.experts.down_proj", (4, 8, 16), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == torch.bfloat16
    assert abs(float(a.float().std()) - 16 ** -0.5) < 0.03
    conv = captions.draw(5, "vision", "patch_embedding.weight", (64, 3, 14, 14), "cpu")
    assert abs(float(conv.float().std()) - 588 ** -0.5) < 0.01
    norm = captions.draw(5, "lm", "model.norm.weight", (4096,), "cpu").float()
    bias = captions.draw(5, "lm", "mlp.gate.e_score_correction_bias", (4096,), "cpu").float()
    assert abs(float(norm.mean()) - 1) < 0.01 and abs(float(bias.std()) - 0.05) < 0.005


def test_caption_vocabulary_maps_every_id_to_words_the_sdxl_vocabulary_spells(tmp_path):
    from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer

    vocab = captions.CaptionVocab(4096, seed=11)
    assert vocab.encode("</s>", add_special_tokens=False) == [4096]
    assert vocab.encode("a b")[0] == captions.CaptionVocab.BOS
    ids = np.arange(2, 40)
    text = vocab.decode(list(ids) + [4096])
    assert len(text.split()) == len(ids)
    captions.write_sdxl_vocab(str(tmp_path))
    tok = SDXLTokenizer(str(tmp_path / "tokenizer"), str(tmp_path / "tokenizer_2"))
    words = " ".join(w.rstrip(".") for w in text.split())
    ids_1, ids_2 = tok(words)
    assert ids_1.shape == (1, 77) and ids_1[0, 0] == 49406
    body = ids_1[0, 1:list(ids_1[0]).index(49407)]
    assert len(ids) <= len(body) <= 3 * len(ids) and (body < 49406).all()
    assert captions.CaptionVocab(4096, 11).words == vocab.words


def test_reference_networks_hold_the_ports_names_at_published_widths():
    from faithdiff_tpu_torch.captioner import CLIPVisionConfig, CLIPVisionTower, VisionProjector
    from faithdiff_tpu_torch.config import CLIPTextConfig
    from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder

    cap = FULL["captioner"]
    ref = ref_captioner.build_captioner(FULL, "meta")
    with torch.device("meta"):
        port = {"vision": CLIPVisionTower(CLIPVisionConfig(**cap["vision"])),
                "projector": VisionProjector(FULL["hidden_size"], cap["vision"]["hidden_size"]),
                "text_encoders": SDXLTextEncoder(*(CLIPTextConfig(**c)
                                                   for c in cap["text_encoders"]))}
    for part in ref:
        a = {k: tuple(v.shape) for k, v in ref[part].state_dict().items()}
        b = {k: tuple(v.shape) for k, v in port[part].state_dict().items()}
        assert a == b, part


def test_reference_lm_is_the_ports_reference():
    from faithdiff_tpu_torch.captioner import deepseek_v3_reference

    with open(ref_lm.__file__) as a, open(deepseek_v3_reference.__file__) as b:
        assert a.read() == b.read()


def test_moe_and_wide_attention_work_by_hand():
    cfg = FULL
    d, f = 2048, 1408
    flops, nbytes = caption_roofline.moe_step_work(cfg, 1)
    assert flops == 2 * (6 * 3 * d * f + 3 * d * 2 * f + d * 64)
    assert nbytes == 2 * (6 * 3 * d * f + 3 * d * 2 * f + d * 64 + 2 * d)
    _, prefill_bytes = caption_roofline.moe_step_work(cfg, 620)
    assert prefill_bytes == 2 * (64 * 3 * d * f + 3 * d * 2 * f + d * 64 + 2 * 620 * d)
    # decode is bound by the bytes of 8 experts a layer: ~41 us at 3.35 TB/s
    per_layer = caption_roofline.moe_least_seconds(cfg, 620, 2) - \
        caption_roofline.moe_least_seconds(cfg, 620, 1)
    assert 26 * 40e-6 < per_layer < 26 * 42e-6
    flops, nbytes = caption_roofline.mla_prefill_work(cfg, 620)
    assert flops == 2 * 16 * (620 * 621 / 2) * (192 + 128)
    assert nbytes == 2 * 16 * 620 * (2 * 192 + 2 * 128)


def _span(i, name, ms, parent=None, **counters):
    return dict(name=name, id=i, parent=parent, attrs={}, start_ns=0, end_ns=0,
                host_ms=ms, device_start_ms=0, device_end_ms=ms, device_ms=ms,
                counters=counters)


def test_readers_on_synthetic_records_and_without_them():
    run = harness.Run(FULL, {}, 1, "cpu", {})
    names = ["caption.ms_per_image", "caption.prefill_ms", "caption.decode_ms_per_token",
             "caption.share_pct", "caption.launches_per_token", "moe.roofline_pct",
             "flash_wide.roofline_pct"]
    assert all(harness.reader(n)(run) is None for n in names)
    run.geometry = dict(caption_prompt=620)
    run.program = dict(
        spans=[_span(0, "request", 8000.0), _span(1, "caption", 5000.0, 0, **{"caption.tokens": 512}),
               _span(2, "caption.prefill", 60.0, 1), _span(3, "caption.decode", 4599.0, 1)],
        caption=dict(decode=dict(ranges=1, kernels=511 * 2000, kernel_ms=1.0),
                     moe=dict(ranges=26 * 512, kernels=1, kernel_ms=2000.0),  # eager steps
                     mla=dict(ranges=27 * 512, kernels=1, kernel_ms=1.0),
                     wide_ms=1.0, wide_kernels=27, tokens=512, max_expert_load=0))
    got = {n: harness.reader(n)(run) for n in names}
    assert got["caption.ms_per_image"] == 5000.0 and got["caption.prefill_ms"] == 60.0
    assert got["caption.decode_ms_per_token"] == 9.0 and got["caption.share_pct"] == 62.5
    assert got["caption.launches_per_token"] == 2000.0
    least = caption_roofline.moe_least_seconds(FULL, 620, 512)
    assert got["moe.roofline_pct"] == pytest.approx(100 * least / 2.0)
    assert 0 < got["flash_wide.roofline_pct"] < 100
    # a shorter eager caption: the ranges hold the prefill and 63 steps
    run.program["caption"]["moe"] = dict(ranges=26 * 64, kernels=1, kernel_ms=1.0)
    least = caption_roofline.moe_least_seconds(FULL, 620, 64)
    assert harness.reader("moe.roofline_pct")(run) == pytest.approx(100 * least / 1e-3)
