"""Port: int8 serving (ops/quant.py, blocks.Int8Conv2d / Int8ConvTranspose2d,
blocks.int8_serve, engine/inference.calibrate_int8, convert.quant_from_jax)
against the JAX package's (csbsr_tpu/ops/quant.py, blocks.INT8_SERVE), on
the CPU, on numpy-seeded inputs.

The JAX side is switched to int8 serving with
`monkeypatch.setattr(csbsr_tpu.models.blocks, "INT8_SERVE", True)` (and
INT8_SCOPE for the narrow scope); no file of the package changes. Models are
cut as in tests/test_torch_port_zoo.py: LR 8 x 8, 2 KBPN stages, HRNet at
width 8, random weights carried across by `state_dict_from_jax`.

Tolerances:
  - quantizers: int8 values and float32 scales exactly, in float32 and bf16;
  - single layers: int32 accumulators exactly (both routes: `_int_mm` over
    an int8 im2col, and the float64 plain version); dequantized outputs
    rtol 1e-6 (float32 products of the same integers and scales);
  - calibration: each act_amax within rtol 1e-5 in float32 (the two
    packages compute the activations in another summation order: the port
    the dense reference math, the JAX package its merged and banded forms);
  - whole model in int8 at identical scales (`quant_from_jax`) or with
    dynamic ones: in float64 (both packages, on one image; the JAX package
    scoped x64 and op by op) every quantization decision is the same, and
    the port's int8 outputs equal the JAX package's to 1e-12 in relative L2
    (measured 2.8e-17 to 1.1e-15, static and dynamic, against a
    quantization error of 4.9e-4 to 4.0e-2: a float path would fail).
    In float32 a value within rounding of a quantization boundary flips one
    int8 level, and with random weights a flip cascades: on the flagship at
    LR 8 x 8 the port's own float32 run flips 1 of 393216 inputs of stage
    1's up_conv2 (its inputs 3e-9 apart from the float64 run's), 790 of them
    two stages later, and its seg map ends 0.57% from the float64 one in
    relative L2; the JAX package's jitted float64 run is as far from its
    own op-by-op one (sr 1.7e-5, seg 0.7%). So in float32 the port is held
    to the JAX package's accuracy instead: for sr, kernel, seg and aux, the
    port's int8 output must be within 1.5x of the JAX package's int8 error
    against the float output, and within 2x of that error of the JAX int8
    output. Measured on the CPU (static / dynamic scales), port vs JAX int8
    against JAX int8 vs float: sr 1.8e-5 / 7.2e-5 against 5.1e-4 / 5.0e-4,
    kernel 8.2e-5 / 2.2e-4 against 9.1e-3 / 9.0e-3, seg 8.6e-3 / 9.1e-3
    against 7.9e-3 / 8.2e-3, aux 3.2e-2 / 4.0e-2 against 5.2e-2 / 5.8e-2;
    port int8 vs float: seg 8.2e-3 / 9.4e-3.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

import csbsr_tpu.models.blocks as jax_blocks
from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
from csbsr_tpu.ops import quant as jq
from csbsr_tpu_torch.engine.inference import calibrate_int8
from csbsr_tpu_torch.models import model_from_cfg
from csbsr_tpu_torch.models.blocks import int8_modules, int8_serve, load_act_amax
from csbsr_tpu_torch.ops import quant as pq
from csbsr_tpu_torch.utils.convert import quant_from_jax, state_dict_from_jax
from tests.test_torch_port_models import nchw, nhwc, random_variables, small_flagship_cfgs
from tests.test_torch_port_baselines import BASELINES, baseline_cfgs, shallow_srcnet  # noqa: F401
from tests.test_torch_port_zoo import RECIPES, narrow_hrnet, zoo_cfgs  # noqa: F401

_BF16 = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_equal_jax_exactly(dtype):
    jdt, tdt = _BF16[dtype]
    rng = np.random.RandomState(0)
    kernel = (rng.randn(3, 3, 8, 6) * 0.2).astype(np.float32)
    kernel[..., 2] = 0.0  # an all-zero output channel: scale 1/127
    q_j, s_j = jq.quantize_weight(jnp.asarray(kernel), out_axis=3)
    q_p, s_p = pq.quantize_weight(_hwio_to_oihw(kernel), out_axis=0)
    np.testing.assert_array_equal(q_p.numpy(), np.transpose(np.asarray(q_j), (3, 2, 0, 1)))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    # transposed layout: (k, k, O, I) out axis 2 <-> (I, O, k, k) out axis 1
    qt_j, st_j = jq.quantize_weight(jnp.asarray(kernel), out_axis=2)
    qt_p, st_p = pq.quantize_weight(_hwio_to_oihw(kernel), out_axis=1)
    np.testing.assert_array_equal(qt_p.numpy(), np.transpose(np.asarray(qt_j), (3, 2, 0, 1)))
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_j))

    x = (rng.randn(2, 5, 6, 4) * 3).astype(np.float32)
    x[0, 0, 0, :] = [1.5, -2.5, 0.5, 127.0 / 2]  # values on .5 after scaling: half to even
    xj = jnp.asarray(x).astype(jdt)
    xp = nchw(x).to(tdt)
    for amax in (None, 63.5, 0.0):
        q_j, s_j = jq.quantize_act(xj, None if amax is None else jnp.float32(amax))
        q_p, s_p = pq.quantize_act(xp, None if amax is None else torch.tensor(amax))
        np.testing.assert_array_equal(np.transpose(q_p.numpy(), (0, 2, 3, 1)), np.asarray(q_j))
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))


# (name, kind, Cin, Cout, k, stride, padding, dilation, groups, H)
LAYERS = [
    ("3x3 s1", "conv", 8, 12, 3, 1, 1, 1, 1, 9),
    ("3x3 s1 Cin 3", "conv", 3, 5, 3, 1, 1, 1, 1, 7),
    ("1x1", "conv", 16, 1, 1, 1, 0, 1, 1, 6),
    ("7x7 s2 p3", "conv", 3, 8, 7, 2, 3, 1, 1, 12),
    ("3x3 dilated 2", "conv", 8, 8, 3, 1, 2, 2, 1, 10),
    ("k8 s4 p2", "conv", 8, 8, 8, 4, 2, 1, 1, 16),
    ("grouped 3x3 (groups C/4)", "conv", 24, 24, 3, 1, 1, 1, 6, 8),
    ("grouped, chunks of GROUP_CHUNK", "conv", 72, 72, 3, 1, 1, 1, 18, 5),
    ("k8 s4 p2 transposed", "deconv", 8, 6, 8, 4, 2, 1, 1, 5),
    ("k8 s4 p2 transposed Cin 3", "deconv", 3, 8, 8, 4, 2, 1, 1, 4),
    ("k4 s2 p1 transposed", "deconv", 8, 4, 4, 2, 1, 1, 1, 6),
]


def _jax_acc(kind, xq, wq, s, p, d, g, k):
    if kind == "deconv":
        return lax.conv_transpose(xq, wq, (s, s), [(k - 1 - p, k - 1 - p)] * 2,
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                  transpose_kernel=True, preferred_element_type=jnp.int32)
    return lax.conv_general_dilated(xq, wq, (s, s), [(p, p)] * 2, rhs_dilation=(d, d),
                                    feature_group_count=g,
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    preferred_element_type=jnp.int32)


@pytest.mark.parametrize("layer", LAYERS, ids=[l[0] for l in LAYERS])
def test_int8_layer_accumulators_equal_jax(layer):
    _, kind, cin, cout, k, s, p, d, g, h = layer
    rng = np.random.RandomState(k + cin)
    x = rng.randn(2, h, h + 1, cin).astype(np.float32)
    if kind == "deconv":  # JAX's transposed-conv kernel layout (k, k, O, I)
        kernel = (rng.randn(k, k, cout, cin) / np.sqrt(cin * k * k)).astype(np.float32)
        wt = _hwio_to_oihw(kernel)  # (I, O, k, k), torch's ConvTranspose2d layout
        wq_j, ws_j = jq.quantize_weight(jnp.asarray(kernel), out_axis=2)
        wq_p, ws_p = pq.quantize_weight(wt, out_axis=1)
        y_j = jq.int8_conv_transpose(jnp.asarray(x), jnp.asarray(kernel), strides=(s, s),
                                     padding=[(k - 1 - p, k - 1 - p)] * 2,
                                     out_dtype=jnp.float32)
        y_p = pq.int8_conv_transpose(nchw(x), wt, s, p)
    else:
        kernel = (rng.randn(k, k, cin // g, cout) / np.sqrt(cin // g * k * k)).astype(np.float32)
        wt = _hwio_to_oihw(kernel)
        wq_j, ws_j = jq.quantize_weight(jnp.asarray(kernel), out_axis=3)
        wq_p, ws_p = pq.quantize_weight(wt, out_axis=0)
        y_j = jq.int8_conv(jnp.asarray(x), jnp.asarray(kernel), strides=(s, s),
                           padding=[(p, p)] * 2, dilation=(d, d), groups=g,
                           out_dtype=jnp.float32)
        y_p = pq.int8_conv(nchw(x), wt, s, p, d, g)
    xq_j, _ = jq.quantize_act(jnp.asarray(x), None)
    xq_p, _ = pq.quantize_act(nchw(x))
    acc_j = np.asarray(_jax_acc(kind, xq_j, wq_j, s, p, d, g, k))
    for route in ("int_mm", "plain"):
        if kind == "deconv":
            acc = pq.conv_transpose_acc(xq_p, wq_p, s, p, route=route)
        else:
            acc = pq.conv_acc(xq_p, wq_p, s, p, d, g, route=route)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(np.transpose(acc.numpy(), (0, 2, 3, 1)), acc_j,
                                      err_msg=route)
    np.testing.assert_allclose(nhwc(y_p), np.asarray(y_j), rtol=1e-6, atol=0)


# (input shape, weight shape, stride, padding, dilation, groups) for the
# _int_mm route's edges: M <= 16 (one small patch), K and N not multiples
# of 8 (Cin 3, Cout 1 or 3), a ragged last group chunk
EDGES = [((1, 3, 2, 2), (3, 3, 3, 3), 1, 1, 1, 1), ((1, 5, 4, 3), (1, 5, 1, 1), 1, 0, 1, 1),
         ((2, 64, 6, 6), (64, 4, 3, 3), 1, 1, 1, 16), ((1, 80, 5, 5), (80, 4, 3, 3), 1, 1, 1, 20),
         ((1, 9, 11, 13), (7, 9, 8, 8), 4, 2, 1, 1), ((3, 6, 9, 9), (10, 6, 3, 3), 2, 1, 1, 1)]


@pytest.mark.parametrize("edge", EDGES, ids=[str(e[:2]) for e in EDGES])
def test_plain_version_equals_int_mm_route_on_cpu(edge):
    xs, ws, s, p, d, g = edge
    gen = torch.Generator().manual_seed(sum(xs) + sum(ws))
    xq = torch.randint(-127, 128, xs, generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, ws, generator=gen).to(torch.int8)
    assert torch.equal(pq.conv_acc(xq, wq, s, p, d, g, route="int_mm"),
                       pq.conv_acc(xq, wq, s, p, d, g, route="plain"))
    if g == 1:  # the same operands as a transposed conv (k a multiple of s)
        wt = torch.randint(-127, 128, (xs[1], 5, 4, 4), generator=gen).to(torch.int8)
        assert torch.equal(pq.conv_transpose_acc(xq, wt, 2, 1, route="int_mm"),
                           pq.conv_transpose_acc(xq, wt, 2, 1, route="plain"))
    assert pq.conv_acc(xq, wq, s, p, d, g).dtype == torch.int32  # CPU default: plain


def _jax_quant_names(jcfg, scope="all"):
    """Port module names of the JAX model's `quant` collection (shapes only)."""
    jm = jax_model_from_cfg(jcfg)
    x = jnp.zeros((1, 8, 8, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "INT8_SERVE", True)
        mp.setattr(jax_blocks, "INT8_SCOPE", scope)
        v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, None, False, train=False))
        _, mut = jax.eval_shape(lambda var: jm.apply(var, x, None, False, train=False,
                                                     clip_sr=True, mutable=["quant"]), v)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), mut["quant"])
    return set(quant_from_jax(zeros))


QUANT_SETS = ["flagship", *RECIPES, "flagship narrow", "unet16 deconv", *BASELINES]


@pytest.mark.parametrize("name", QUANT_SETS)
def test_quantized_set_equals_jax_quant_collection(name, narrow_hrnet,  # noqa: F811
                                                   shallow_srcnet):  # noqa: F811
    scope = "narrow" if name.endswith("narrow") else "all"
    if name.startswith("flagship"):
        jcfg, cfg = small_flagship_cfgs()
    elif name == "unet16 deconv":
        jcfg, cfg = zoo_cfgs("unet16", extra=["MODEL.UP_SAMPLE_METHOD", "deconv"])
    elif name in BASELINES:
        jcfg, cfg = baseline_cfgs(name)
    else:
        jcfg, cfg = zoo_cfgs(name)
    expected = _jax_quant_names(jcfg, scope)
    model = model_from_cfg(cfg, device="cpu")
    float_keys = set(model.state_dict())
    int8_serve(model, scope)
    got = {n for n, _ in int8_modules(model)}
    assert got == expected, (sorted(got - expected)[:8], sorted(expected - got)[:8])
    if cfg.MODEL.SR == "KBPN":  # SFT conv0: only the feature half runs int8
        sft = model.sr_model.back_projection_stages[0].sft
        assert sft.SFT_scale_conv0.quant_channels == sft.SFT_shift_conv0.quant_channels == 128
        assert sft.SFT_scale_conv1.quant_channels is None
    if name == "unet16 deconv":
        assert any(type(m).__name__ == "Int8ConvTranspose2d" for _, m in int8_modules(model))
    # the state dict is the float model's: a strict load works in either mode
    keys = set(model.state_dict())
    assert keys == float_keys
    assert not any(k.endswith("act_amax") for k in keys)


def _apply(module, var, xs, **kw):
    return module.apply(var, xs, None, False, train=False, clip_sr=True, **kw)


@pytest.fixture(scope="module")
def flagship_int8():
    """The cut-down flagship on both sides: the JAX calibration in float32
    on 3 images (its quant collection, and its outputs, which are the float
    model's), the JAX model and variables, the port model and the input.
    The JAX int8 outputs are fixtures of their own (jax_int8_float32,
    jax_int8_float64), so that a worker computes only those its tests need."""
    jcfg, cfg = small_flagship_cfgs()
    jm = jax_model_from_cfg(jcfg)
    v = random_variables(jm, jnp.zeros((1, 8, 8, 3)), None, False, train=False, seed=5)
    # init declares the SFT layers' `quant` variables too (every collection is
    # mutable in init): drop their random values, or they act as scales
    v = {k: val for k, val in v.items() if k != "quant"}
    x = np.random.RandomState(6).rand(3, 8, 8, 3).astype(np.float32)
    out = {"x": x, "jax": (jcfg, jm, v)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "INT8_SERVE", True)
        # the calibration pass runs the float convs: its outputs are the float model's
        out["ref"], mut = jax.device_get(jax.jit(
            lambda var: _apply(jm, var, jnp.asarray(x), mutable=["quant"]))(v))
        out["quant"] = mut["quant"]
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    out["model"] = model
    return out


@pytest.fixture(scope="module")
def jax_int8_float32(flagship_int8):
    """JAX int8 outputs on the 3 images in float32, jitted: {static, dynamic}."""
    f = flagship_int8
    _, jm, v = f["jax"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "INT8_SERVE", True)
        int8 = jax.jit(lambda var: _apply(jm, var, jnp.asarray(f["x"])))
        static, dynamic = jax.device_get((int8({**v, "quant": f["quant"]}), int8(v)))
    return {"static": static, "dynamic": dynamic}


@pytest.fixture(scope="module")
def jax_int8_float64(flagship_int8):
    """JAX int8 outputs on the first image in float64, op by op: {static, dynamic}.

    Op by op, not jitted: XLA's fusions round the float64 activations
    differently (jitted and not, the package's own int8 outputs differ by
    8e-6 in sr and 0.8% in seg here, a flip cascade); op by op computes what
    its code says. It compiles each op on its own, which takes most of the
    file's time (about 35 s on one CPU core) whatever the image count: hence
    one image, and a fixture of its own."""
    f = flagship_int8
    jcfg, _, v = f["jax"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_blocks, "INT8_SERVE", True)
        jm64 = jax_model_from_cfg(jcfg, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        x64 = jnp.asarray(f["x"][:1], jnp.float64)
        static, dynamic = jax.device_get((_apply(jm64, {**v64, "quant": f["quant"]}, x64),
                                          _apply(jm64, v64, x64)))
    return {"static": static, "dynamic": dynamic}


def test_calibration_equals_jax(flagship_int8):
    f = flagship_int8
    model = calibrate_int8(f["model"], nchw(f["x"]))
    want = quant_from_jax(f["quant"])
    got = {n: m.act_amax for n, m in int8_modules(model)}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(float(got[n]), float(want[n]), rtol=1e-5, err_msg=n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("scales,dtype", [("static", "float64"), ("dynamic", "float64"),
                                          ("static", "float32"), ("dynamic", "float32")])
def test_int8_model_equals_jax_at_identical_scales(flagship_int8, scales, dtype, request):
    f = flagship_int8
    jint8 = request.getfixturevalue(f"jax_int8_{dtype}")[scales]
    n = 1 if dtype == "float64" else len(f["x"])  # the JAX float64 runs take one image
    model = int8_serve(f["model"])
    if scales == "static":
        load_act_amax(model, quant_from_jax(f["quant"]))
    else:
        for _, m in int8_modules(model):
            m.act_amax = None
    tdt = torch.float64 if dtype == "float64" else torch.float32
    model.to(tdt)
    model.dtype = tdt
    try:
        with torch.no_grad():
            out = model(nchw(f["x"][:n]).to(tdt), clip_sr=True)
    finally:
        model.float()
        model.dtype = torch.float32
    jfloat = {k: f["ref"][k][:n] for k in ("sr", "kernel", "seg", "aux")}
    for key in ("sr", "kernel", "seg", "aux"):
        got = out[key].numpy() if key == "kernel" else np.transpose(out[key].numpy(),
                                                                     (0, 2, 3, 1))
        port_err = _rel_l2(got, jint8[key])
        quant_err = _rel_l2(jint8[key], jfloat[key])
        assert quant_err > 1e-6, (key, quant_err)  # the int8 path did run
        port_quant_err = _rel_l2(got, jfloat[key])
        print(f"{scales} {dtype} {key}: port vs JAX int8 {port_err:.3g}, JAX int8 vs float "
              f"{quant_err:.3g}, port int8 vs JAX float {port_quant_err:.3g}")
        if dtype == "float64":
            assert port_err < 1e-12, (key, port_err)
        else:  # see the module docstring: flips cascade
            assert port_quant_err < 1.5 * quant_err, (key, port_quant_err, quant_err)
            assert port_err < 2.0 * quant_err, (key, port_err, quant_err)


@pytest.mark.parametrize("inference", [False, True], ids=["tensors", "inference_tensors"])
def test_int8_weight_quantization_follows_a_state_dict_load(inference):
    """The kept int8 weight is quantized anew after load_state_dict, also
    for a model built and loaded in inference mode (no version counter)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, 5, 7, generator=gen)
    state = {k: torch.randn(s, generator=gen) for k, s in (("0.weight", (4, 6, 3, 3)),
                                                          ("0.bias", (4,)))}
    with torch.inference_mode(inference):
        model = int8_serve(torch.nn.Sequential(torch.nn.Conv2d(6, 4, 3, padding=1))).eval()
        before = model(x)
        model.load_state_dict(state, strict=True)
        after = model(x)
    want = pq.int8_conv(x, state["0.weight"], 1, 1) + state["0.bias"][:, None, None]
    assert not torch.equal(before, want)
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_int8_train_mode_and_calibration_run_the_float_conv(flagship_int8):
    """Train mode and the calibration pass compute the float conv, as the
    JAX package's train path and `mutable=["quant"]` pass do."""
    f = flagship_int8
    model = f["model"]
    with torch.no_grad():
        model.eval()
        float_out = model_from_cfg(small_flagship_cfgs()[1], device="cpu")
        float_out.load_state_dict(model.state_dict(), strict=True)
        want = float_out(nchw(f["x"]), clip_sr=True)["sr"]
        calibrate_int8(model, nchw(f["x"]))
        np.testing.assert_allclose(nhwc(want), np.asarray(f["ref"]["sr"]), rtol=2e-5,
                                   atol=2e-5)
        mods = [m for _, m in int8_modules(model)]
        for m in mods:
            m.calibrating = True
        try:
            got = model(nchw(f["x"]), clip_sr=True)["sr"]
        finally:
            for m in mods:
                m.calibrating = False
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        model.train()
        try:
            conv = model.sr_model.back_projection_stages[0].up.up_conv2.layer
            y = conv(torch.ones(1, 128, 16, 16))
            torch.testing.assert_close(y, torch.nn.functional.conv2d(
                torch.ones(1, 128, 16, 16), conv.weight, conv.bias, conv.stride, conv.padding))
        finally:
            model.eval()


def test_int8_accuracy_agreement_reports_the_four_figures():
    """int8_accuracy.agreement: bf16 (here float32) against int8 calibrated
    on the same patches; random weights, so only the figures' presence and
    the int8 path's running are held."""
    from csbsr_tpu_torch.int8_accuracy import agreement

    model = model_from_cfg(small_flagship_cfgs()[1], device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 8, 8).astype(np.float32))
    out = agreement(model, x)
    assert out["int8_convs"] == 79 and out["scope"] == "all"
    assert 20.0 < out["sr_psnr_bf16_vs_int8"] < float("inf")
    assert 0.0 <= out["seg_agreement_iou@0.5"] <= 1.0
    assert 0.0 < out["seg_max_prob_deviation"] < 0.5 and out["kernel_psnr"] > 20.0
