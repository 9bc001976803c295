"""The port's copies of configs, perf flags and the overload controller
equal the JAX package's originals."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import EncoderSpec as JaxEncoderSpec  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core import overload as jax_overload  # noqa: E402
from repro.insights.rules import recommend_nppn as jax_recommend  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxPerfFlags  # noqa: E402
from repro_torch.configs import (ModelConfig, get_config, list_archs,  # noqa: E402
                                 reduced_config)
from repro_torch.core import overload  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags  # noqa: E402


def test_registered_archs():
    assert list_archs() == ["gemma3-1b", "granite-moe-1b-a400m",
                            "internvl2-2b", "jamba-1.5-large-398b",
                            "llsc-100m", "mamba2-370m", "minicpm3-4b",
                            "phi3-medium-14b", "qwen1.5-4b",
                            "qwen3-moe-30b-a3b", "whisper-base"]


MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_equals_reference(arch, reduced):
    mine, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("variant", ["full", "reduced", "reduced_2_layers",
                                     "reduced_gelu"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_counts_and_flops_equal_reference(arch, variant):
    """count_params, count_params_analytic (total and active) and
    model_flops of the reference; model_flops counts the active parameters
    only."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    if variant != "full":
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    change = {"reduced_2_layers": {"n_layers": 2},
              "reduced_gelu": {"act": "gelu"}}.get(variant, {})
    cfg = dataclasses.replace(cfg, **change)
    ref = dataclasses.replace(ref, **change)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for active in (False, True):
        assert model_lib.count_params_analytic(cfg, active) == \
            jax_model.count_params_analytic(ref, active)
    active = model_lib.count_params_analytic(cfg, True)
    assert active < model_lib.count_params(cfg)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training) == \
            (6.0 if training else 2.0) * active * 7


def test_granite_counts():
    cfg = get_config("granite-moe-1b-a400m")
    assert model_lib.count_params(cfg) == 1_334_628_352
    assert model_lib.count_params_analytic(cfg, True) == 428_658_688
    assert model_lib.model_flops(cfg, 256, training=True) == \
        6 * 428_658_688 * 256


@pytest.mark.parametrize("reduced", [False, True])
def test_jamba_config_equals_reference(reduced):
    mine = get_config("jamba-1.5-large-398b")
    ref = jax_get_config("jamba-1.5-large-398b")
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.opt_dtype == "bfloat16"


@pytest.mark.parametrize("change", [{}, {"n_layers": 5}, {"n_layers": 1},
                                    "reduced", "reduced_2_layers"])
def test_jamba_param_counts_and_flops_equal_reference(change):
    """count_params, count_params_analytic (total and active) and
    model_flops of the reference, from the shapes alone: at 72 layers (9
    stacked periods), at the 5 of chip_smoke's serve (no stacked period, 5
    remainder layers), at 1, and on the reduced config (one period of 8)
    and 2 of its layers."""
    cfg = get_config("jamba-1.5-large-398b")
    ref = jax_get_config("jamba-1.5-large-398b")
    if isinstance(change, str):
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
        change = {"n_layers": 2} if change == "reduced_2_layers" else {}
    cfg = dataclasses.replace(cfg, **change)
    ref = dataclasses.replace(ref, **change)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for active in (False, True):
        assert model_lib.count_params_analytic(cfg, active) == \
            jax_model.count_params_analytic(ref, active)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training)


def test_jamba_counts():
    cfg = get_config("jamba-1.5-large-398b")
    assert model_lib.count_params(cfg) == 397_596_263_520
    five = dataclasses.replace(cfg, n_layers=5)
    assert (five.n_periods, five.n_remainder) == (0, 5)
    assert model_lib.count_params(five) == 23_984_828_032
    assert model_lib.count_params_analytic(five, True) == 7_073_394_304
    assert model_lib.model_flops(five, 1, training=False) == \
        2 * 7_073_394_304
    one = dataclasses.replace(cfg, n_layers=1)
    assert model_lib.count_params(one) == 2_082_857_888


@pytest.mark.parametrize("reduced", [False, True])
def test_mamba2_config_equals_reference(reduced):
    mine, ref = get_config("mamba2-370m"), jax_get_config("mamba2-370m")
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("variant", ["full", "reduced", "reduced_no_ffn"])
def test_mamba2_param_count_and_flops_equal_reference(variant):
    cfg, ref = get_config("mamba2-370m"), jax_get_config("mamba2-370m")
    if variant != "full":
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    if variant == "reduced_no_ffn":
        cfg = dataclasses.replace(cfg, d_ff=0, n_layers=2)
        ref = dataclasses.replace(ref, d_ff=0, n_layers=2)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training)


@pytest.mark.parametrize("reduced", [False, True])
def test_llsc_config_equals_reference(reduced):
    mine, ref = get_config("llsc-100m"), jax_get_config("llsc-100m")
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_equals_reference(reduced):
    cfg, ref = get_config("llsc-100m"), jax_get_config("llsc-100m")
    if reduced:
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    assert model_lib.model_flops(cfg, 7, training=False) == \
        jax_model.model_flops(ref, 7, training=False)


def test_unsupported_features_raise():
    """A frontend the repo has no stub for, and the audio stub without an
    encoder to take its frames, raise; internvl2's patch stub, planted in
    llsc-100m, is supported since it was ported with internvl2 (it adds no
    parameter: the count is the reference's and llsc-100m's), as QKV bias
    and MLA are since qwen1.5 and minicpm3."""
    llsc = get_config("llsc-100m")
    for change, match in (({"frontend": "video_stub", "frontend_len": 8},
                           "frontend video_stub"),
                          ({"frontend": "audio_stub"},
                           "frontend audio_stub without an encoder")):
        with pytest.raises(NotImplementedError, match=match):
            model_lib.count_params(dataclasses.replace(llsc, **change))
    patch = {"frontend": "patch_stub", "frontend_len": 8}
    assert model_lib.count_params(dataclasses.replace(llsc, **patch)) == \
        jax_model.count_params(dataclasses.replace(
            jax_get_config("llsc-100m"), **patch)) == \
        model_lib.count_params(llsc)
    for change in ({"qkv_bias": True}, {"mla": get_config("minicpm3-4b").mla}):
        model_lib.count_params(dataclasses.replace(llsc, **change))


@pytest.mark.parametrize("arch,change,match", [
    ("internvl2-2b", {"frontend": "video_stub"}, "frontend video_stub"),
    ("gemma3-1b", {"frontend": "video_stub", "frontend_len": 16},
     "frontend video_stub"),
    ("llsc-100m", {"act": "relu"}, "act relu"),
    ("granite-moe-1b-a400m", {"act": "geglu"}, "act geglu"),
    ("whisper-base", {"encoder": JaxEncoderSpec(
        n_layers=2, n_heads=4, n_kv_heads=4, d_ff=64, source_len=16),
        "act": "relu"}, "act relu"),
    ("whisper-base", {"encoder": None},
     "frontend audio_stub without an encoder"),
])
def test_unsupported_mixes_raise(arch, change, match):
    """A frontend the repo has no stub for (planted in internvl2 and in
    gemma3), an FFN act the reference's ``mlp`` does not know (planted in
    llsc-100m and in whisper with a smaller encoder), GeGLU experts (the
    reference's ``moe_ffn`` takes SwiGLU or GELU) and whisper's audio stub
    without its encoder stay unsupported; attention and Mamba-2 layers in
    one pattern (jamba), local attention (gemma3), GeGLU dense FFNs, QKV
    bias (qwen1.5), MLA (minicpm3), the patch stub (internvl2) and the
    encoder-decoder (whisper) do not raise."""
    cfg = dataclasses.replace(jax_get_config(arch), **change)
    mine = ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})
    with pytest.raises(NotImplementedError, match=match):
        model_lib.count_params(mine)


@pytest.mark.parametrize("reduced", [False, True])
def test_gemma3_config_equals_reference(reduced):
    """The copy, and its reduced form (window min(512, 8), embed_scale
    sqrt(64), the local rope base and the pattern kept), equal the
    reference's field for field."""
    mine, ref = get_config("gemma3-1b"), jax_get_config("gemma3-1b")
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.rope_theta_local == 10_000.0 and mine.act == "geglu"
    assert mine.attn_logit_softcap is None
    if reduced:
        assert (mine.attn_window, mine.embed_scale) == (8, 8.0)


@pytest.mark.parametrize("variant", ["full", "reduced", "reduced_6_layers",
                                     "reduced_softcap", "reduced_gelu"])
def test_gemma3_param_counts_and_flops_equal_reference(variant):
    """count_params, count_params_analytic and model_flops of the reference:
    at 26 layers, reduced (7: a period of 6 and one local remainder layer),
    at one period, with a logit cap (no parameters of its own) and with a
    GELU FFN (no w3)."""
    cfg, ref = get_config("gemma3-1b"), jax_get_config("gemma3-1b")
    if variant != "full":
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    change = {"reduced_6_layers": {"n_layers": 6},
              "reduced_softcap": {"attn_logit_softcap": 30.0},
              "reduced_gelu": {"act": "gelu"}}.get(variant, {})
    cfg = dataclasses.replace(cfg, **change)
    ref = dataclasses.replace(ref, **change)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for active in (False, True):
        assert model_lib.count_params_analytic(cfg, active) == \
            jax_model.count_params_analytic(ref, active)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training)


def test_gemma3_counts():
    """999,812,736 parameters: the 262,144 x 1152 embedding (tied) and 26
    layers of 26,839,296 (two norms, q 1152 x 1024, k and v 1152 x 256, o
    1024 x 1152, GeGLU 3 x 1152 x 6912), plus the final norm."""
    cfg = get_config("gemma3-1b")
    layer = 2 * 1152 + 1152 * (1024 + 2 * 256) + 1024 * 1152 \
        + 3 * 1152 * 6912
    assert layer == 26_839_296
    assert model_lib.count_params(cfg) == 262_144 * 1152 + 26 * layer \
        + 1152 == 999_812_736
    assert model_lib.model_flops(cfg, 256, training=True) == \
        6 * 999_812_736 * 256
    six = dataclasses.replace(cfg, n_layers=6)
    assert model_lib.count_params(six) == 262_144 * 1152 + 6 * layer + 1152


def test_perf_flags_copy():
    assert [f.name for f in dataclasses.fields(PerfFlags)] == \
        [f.name for f in dataclasses.fields(JaxPerfFlags)]
    assert PerfFlags().active() == [] and not PerfFlags().flash_kernel
    assert PerfFlags.parse("flash_kernel").active() == ["flash_kernel"]
    with pytest.raises(ValueError):
        PerfFlags.parse("flash_kernel,nope")


@pytest.mark.parametrize("nppn", [-1, 0, 1, 2, 3, 5, 8, 16])
def test_nearest_level_copy(nppn):
    assert overload.nearest_level(nppn) == jax_overload.nearest_level(nppn)
    assert overload.nearest_level(nppn, max_nppn=4) == \
        jax_overload.nearest_level(nppn, max_nppn=4)


@pytest.mark.parametrize("load,used,total", [
    (0.0, 1.0, 80.0), (0.05, 0.5, 80.0), (0.2, 10.0, 80.0),
    (0.5, 50.0, 80.0), (0.9, 1.0, 80.0), (0.01, 30.0, 80.0)])
def test_recommend_nppn_copy(load, used, total):
    assert overload.recommend_nppn(load, used, total) == \
        jax_recommend(load, used, total)


@pytest.mark.parametrize("duties,nppn", [
    ([0.05] * 4, 1), ([0.05] * 4, 4), ([0.3, 0.4], 2), ([0.99] * 8, 4),
    ([0.99] * 8, 3), ([0.7] * 3, 8), ([], 2)])
def test_overload_controller_copy(duties, nppn):
    mine, ref = overload.OverloadController(), jax_overload.OverloadController()
    for d in duties:
        mine.observe(overload.DeviceObservation(d, 2.0, 80.0))
        ref.observe(jax_overload.DeviceObservation(d, 2.0, 80.0))
    a, b = mine.decide(nppn), ref.decide(nppn)
    assert (a.nppn, a.reason) == (b.nppn, b.reason)


@pytest.mark.parametrize("duty,nppn", [(0.35, 1), (0.35, 2), (0.35, 4),
                                       (0.35, 8), (0.05, 8), (1.0, 3)])
def test_packed_throughput_model_copy(duty, nppn):
    assert overload.packed_throughput_model(duty, nppn) == \
        jax_overload.packed_throughput_model(duty, nppn)


NEW_ARCHS = ["qwen1.5-4b", "phi3-medium-14b", "minicpm3-4b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_qwen_phi3_minicpm3_configs_equal_reference(arch, reduced):
    """The copies, and their reduced forms, equal the reference's field for
    field: reduced phi3 keeps GQA (4 query and 2 KV heads), reduced
    minicpm3 keeps MLA at ranks 32 and 16, heads of 8 + 8 and values of 8."""
    mine, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if reduced and arch == "phi3-medium-14b":
        assert (mine.n_heads, mine.n_kv_heads) == (4, 2)
    if reduced and arch == "minicpm3-4b":
        m = mine.mla
        assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
                m.qk_rope_head_dim, m.v_head_dim) == (32, 16, 8, 8, 8)


@pytest.mark.parametrize("variant", ["full", "8_layers", "1_layer",
                                     "reduced", "reduced_2_layers"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_qwen_phi3_minicpm3_counts_and_flops_equal_reference(arch, variant):
    """count_params, count_params_analytic (total and active) and
    model_flops of the reference, from the shapes alone, at full depth, at
    chip_smoke's train depth (8) and card-against-CPU depth (1), and
    reduced."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    if variant.startswith("reduced"):
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    change = {"8_layers": {"n_layers": 8}, "1_layer": {"n_layers": 1},
              "reduced_2_layers": {"n_layers": 2}}.get(variant, {})
    cfg = dataclasses.replace(cfg, **change)
    ref = dataclasses.replace(ref, **change)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for active in (False, True):
        assert model_lib.count_params_analytic(cfg, active) == \
            jax_model.count_params_analytic(ref, active)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training)


@pytest.mark.parametrize("arch,total,layer", [
    # two norms, q k v 2560 x 2560 with their biases, o, SwiGLU 3 x 2560 x
    # 6912; untied 151936 x 2560 embedding and head
    ("qwen1.5-4b", 3_950_369_280,
     2 * 2560 + 4 * 2560 * 2560 + 3 * 2560 + 3 * 2560 * 6912),
    # q 5120 x 5120, k and v 5120 x 1280 (10 KV heads of 128), o, SwiGLU
    # 3 x 5120 x 17920; untied 100352 x 5120
    ("phi3-medium-14b", 14_659_507_200,
     2 * 5120 + 5120 * (5120 + 2 * 1280) + 5120 * 5120 + 3 * 5120 * 17920),
    # wq_a 2560 x 768, q_norm, wq_b 768 x 40 * 96, wkv_a 2560 x 288,
    # kv_norm, wkv_b 256 x 40 * 128, wo 40 * 64 x 2560, SwiGLU 3 x 2560 x
    # 6400; untied 73448 x 2560
    ("minicpm3-4b", 4_261_902_848,
     2 * 2560 + 2560 * 768 + 768 + 768 * 3840 + 2560 * 288 + 256
     + 256 * 5120 + 2560 * 2560 + 3 * 2560 * 6400),
])
def test_qwen_phi3_minicpm3_counts(arch, total, layer):
    cfg = get_config(arch)
    d, V = cfg.d_model, cfg.vocab_size
    assert model_lib.count_params(cfg) == 2 * V * d + cfg.n_layers * layer \
        + d == total
    assert model_lib.model_flops(cfg, 256, training=False) == \
        2 * total * 256


FRONTEND_ARCHS = ["whisper-base", "internvl2-2b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_whisper_internvl2_configs_equal_reference(arch, reduced):
    """The copies, and their reduced forms, equal the reference's field for
    field: reduced whisper keeps an encoder of 2 layers over 16 frames,
    reduced internvl2 GQA (4 query and 2 KV heads) and 8 patches."""
    mine, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        mine, ref = reduced_config(mine), jax_reduced(ref)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if reduced and arch == "whisper-base":
        enc = mine.encoder
        assert (enc.n_layers, enc.n_heads, enc.d_ff, enc.source_len) == \
            (2, 4, 64, 16)
    if reduced and arch == "internvl2-2b":
        assert (mine.n_heads, mine.n_kv_heads, mine.frontend_len) == (4, 2, 8)


@pytest.mark.parametrize("variant", ["full", "1_layer", "reduced",
                                     "reduced_2_layers"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_whisper_internvl2_counts_and_flops_equal_reference(arch, variant):
    """count_params, count_params_analytic (total and active) and
    model_flops of the reference, from the shapes alone, at full depth, at
    chip_smoke's card-against-CPU depth of internvl2 (1) and reduced.  The
    reference's model_flops counts the encoder's parameters for every
    decoder token; so does the port's."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    if variant.startswith("reduced"):
        cfg, ref = reduced_config(cfg), jax_reduced(ref)
    change = {"1_layer": {"n_layers": 1},
              "reduced_2_layers": {"n_layers": 2}}.get(variant, {})
    cfg = dataclasses.replace(cfg, **change)
    ref = dataclasses.replace(ref, **change)
    assert model_lib.count_params(cfg) == jax_model.count_params(ref)
    for active in (False, True):
        assert model_lib.count_params_analytic(cfg, active) == \
            jax_model.count_params_analytic(ref, active)
    for training in (False, True):
        assert model_lib.model_flops(cfg, 7, training=training) == \
            jax_model.model_flops(ref, 7, training=training)


@pytest.mark.parametrize("arch,total,layer,encoder", [
    # untied 51865 x 512; a decoder layer: ln1, ln_x, ln2, self and cross
    # attention of 4 x 512 x 512 each, GELU 2 x 512 x 2048; an encoder
    # layer: ln1, ln2, attention, GELU; final_norm and enc_norm
    ("whisper-base", 97_166_336,
     3 * 512 + 8 * 512 * 512 + 2 * 512 * 2048,
     2 * 512 + 4 * 512 * 512 + 2 * 512 * 2048),
    # untied 92553 x 2048; q 2048 x 2048, k and v 2048 x 1024 (8 KV heads
    # of 128), o, SwiGLU 3 x 2048 x 8192; no encoder
    ("internvl2-2b", 1_889_146_880,
     2 * 2048 + 2048 * (2048 + 2 * 1024) + 2048 * 2048 + 3 * 2048 * 8192,
     0),
])
def test_whisper_internvl2_counts(arch, total, layer, encoder):
    cfg = get_config(arch)
    d, V = cfg.d_model, cfg.vocab_size
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    assert model_lib.count_params(cfg) == 2 * V * d + cfg.n_layers * layer \
        + n_enc * encoder + d * (1 + bool(n_enc)) == total
    assert model_lib.model_flops(cfg, 256, training=True) == \
        6 * total * 256
