"""Port: KBPN, PSPNet and the joint CSBSRModel forward in eval against the
JAX package, with weights carried across by csbsr_tpu_torch.utils.convert.

The JAX variables are random values (numpy seed) in the param tree that
`jax.eval_shape(model.init)` reports, with random biases, PReLU slopes and
BatchNorm statistics so that a misrouted leaf shows. Both sides run in
float32 on the CPU.

Tolerance: atol = rtol = 2e-5. The port runs the dense reference math; the
JAX package's default forms (merged narrow convs, banded kernel map,
GAP-collapsed conv) are the same math summed in another order, which moves
float32 results by about 1e-6 here.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from csbsr_tpu.config import get_cfg_defaults as jax_cfg_defaults
from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
from csbsr_tpu.models.kbpn import KBPN as JaxKBPN
from csbsr_tpu.models.pspnet import PSPNet as JaxPSPNet
from csbsr_tpu_torch.config import get_cfg_defaults
from csbsr_tpu_torch.models import model_from_cfg
from csbsr_tpu_torch.models.kbpn import KBPN
from csbsr_tpu_torch.models.pspnet import PSPNet
from csbsr_tpu_torch.utils.convert import convert_tree, state_dict_from_jax, translate_kbpn, \
    translate_pspnet

TOL = 2e-5
FLAGSHIP_YAML = "configs/config_csbsr_pspnet.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_variables(module, *args, seed=0, shapes=None, **kwargs):
    """Numpy-valued variables in the shape tree of module.init(*args) (or
    `shapes`, that tree from an earlier call for the same module)."""
    if shapes is None:
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "alpha":
            v = 0.05 + 0.2 * rng.rand(*shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = 0.5 + rng.rand(*shape)
        else:  # bias, mean
            v = 0.05 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def small_flagship_cfgs(image_size=32, stages=2):
    """configs/config_csbsr_pspnet.yaml cut to size, for both packages."""
    out = []
    for cfg in (jax_cfg_defaults(), get_cfg_defaults()):
        cfg.merge_from_file(FLAGSHIP_YAML)
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", [image_size, image_size],
                             "MODEL.NUM_STAGES", stages, "TPU.COMPUTE_DTYPE", "float32"])
        out.append(cfg)
    return out


def joint_models(image_size=32, stages=2, seed=0, shapes=None):
    """(jax_cfg, port_cfg, jax_model, jax_variables, port_model) of the
    cut-down flagship, with the JAX weights carried into the port (strict
    load); `shapes` is the variables' shape tree of an earlier call at the
    same size, if any."""
    jcfg, cfg = small_flagship_cfgs(image_size, stages)
    jm = jax_model_from_cfg(jcfg)
    lr = image_size // jcfg.MODEL.SCALE_FACTOR
    variables = random_variables(jm, jnp.zeros((1, lr, lr, 3)), None, False, train=False,
                                 seed=seed, shapes=shapes)
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jcfg, cfg, jm, variables, model


def test_kbpn_forward_equals_jax():
    x = np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32)
    jm = JaxKBPN(num_stages=2, md_ch=16, estimate_ksize=7, ksize_output=21)
    v = random_variables(jm, jnp.asarray(x))
    sr_j, k_j = jax.jit(jm.apply)(v, jnp.asarray(x))
    m = KBPN(num_stages=2, md_ch=16, estimate_ksize=7, ksize_output=21)
    result = m.load_state_dict(convert_tree(v["params"], None, translate_kbpn), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    with torch.no_grad():
        sr, k = m(nchw(x))
    np.testing.assert_allclose(nhwc(sr), np.asarray(sr_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_j), rtol=TOL, atol=TOL)
    # one kernel of 21x21 per sample, sum 1
    np.testing.assert_allclose(k.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_pspnet_resnet34_forward_equals_jax():
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    jm = JaxPSPNet()
    v = random_variables(jm, jnp.asarray(x), seed=3)
    main_j, aux_j = jax.jit(jm.apply)(v, jnp.asarray(x))
    m = PSPNet().eval()
    m.load_state_dict(convert_tree(v["params"], v["batch_stats"], translate_pspnet), strict=True)
    with torch.no_grad():
        main, aux = m(nchw(x))
    np.testing.assert_allclose(nhwc(main), np.asarray(main_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(nhwc(aux), np.asarray(aux_j), rtol=TOL, atol=TOL)


def test_joint_flagship_forward_equals_jax():
    jcfg, cfg, jm, variables, model = joint_models()
    x = np.random.RandomState(4).rand(3, 8, 8, 3).astype(np.float32)
    out_j = jax.jit(lambda v, a: jm.apply(v, a, None, False, train=False, clip_sr=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(nchw(x), clip_sr=True)
    for key in ("sr", "seg", "aux"):
        np.testing.assert_allclose(nhwc(out[key]), np.asarray(out_j[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["kernel"].numpy(), np.asarray(out_j["kernel"]),
                               rtol=TOL, atol=TOL)
    assert out["sr"].shape == (3, 3, 32, 32) and out["kernel"].shape == (3, 21 * 21)


def test_state_dict_keys_match_the_port_exactly():
    """Every key the converter emits is a port key and vice versa, for the
    full-depth flagship (4 stages, md 128, kernel 7 -> 21)."""
    jcfg, cfg = small_flagship_cfgs(stages=4)
    jm = jax_model_from_cfg(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                            None, False, train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    port = model_from_cfg(cfg, device="cpu").state_dict()
    assert set(sd) == set(port)
    assert all(tuple(sd[k].shape) == tuple(port[k].shape) for k in sd)
    assert any(k.startswith("sr_model.back_projection_stages.3.kb.kernel_predictor.fe_kernel.0")
               for k in sd)
    assert "segmentation_model.feats.layer3.5.bn2.running_var" in sd


# configurations the port does not build yet (ROADMAP.md, queue 1): the
# PSPNet extractor zoo, KBPN's other variants, DSRL's SR or detector alone
UNPORTED = [("PSPNet", "KBPN", ["TPU.PSPNET_BACKEND", "resnet50"]),
            ("PSPNet", "KBPN", ["MODEL.SUM_LR_ERROR_POS", "LR"]),
            ("PSPNet", "KBPN", ["MODEL.SR_PIXEL_SHUFFLE", True]),
            ("PSPNet", "DSRL", []), ("DSRL", "KBPN", [])]


@pytest.mark.parametrize("detector,sr,extra", UNPORTED)
def test_unported_models_raise(detector, sr, extra):
    cfg = get_cfg_defaults()
    cfg.MODEL.DETECTOR_TYPE, cfg.MODEL.SR = detector, sr
    cfg.merge_from_list(extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_from_cfg(cfg, device="cpu")


def test_compute_dtype_follows_config():
    cfg = small_flagship_cfgs(image_size=16, stages=1)[1]
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = model_from_cfg(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.rand(1, 3, 4, 4))
    assert out["seg"].dtype == torch.bfloat16 and out["kernel"].dtype == torch.float32
