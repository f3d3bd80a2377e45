"""The CUDA kernels on the card against their plain versions, at small odd
shapes that exercise the masked edges.  Marked ``cuda``: they skip where
there is no CUDA device.  Run them on a GPU host with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import network  # noqa: E402
from repro_torch.kernels import dwconv2d, ops, pwconv, ref  # noqa: E402
from repro_torch.kernels import separable_fused as sf  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.mobilenet_inference import (launch_counts,  # noqa: E402
                                             rel_err, reset_launch_counts)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _r(shape, dev, dtype, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,h,w,c,stride,hf,vec", [
    (2, 9, 11, 12, 1, 3, 4), (1, 8, 8, 20, 2, 3, 4), (2, 7, 9, 6, 2, 5, 1),
    (1, 10, 10, 5, 1, 3, 1), (1, 12, 12, 8, 1, 7, 4)])
def test_dwconv2d_kernel(dev, b, h, w, c, stride, hf, vec, dtype):
    x = ref.pad_same(_r((b, h, w, c), dev, dtype), hf, hf, stride)
    f = _r((hf, hf, c), dev, dtype, 1 / hf)
    got = dwconv2d.dwconv2d(x, f, stride=stride, block_c=vec)
    want = dwconv2d.dwconv2d_plain(x, f, stride=stride)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("tile", [(64, 64, 16), (128, 128, 32),
                                  (64, 128, 8), (128, 64, 16)])
@pytest.mark.parametrize("g,ci,co,act", [(37, 20, 50, "relu6"),
                                         (300, 130, 70, "gelu"),
                                         (5, 8, 3, "silu")])
def test_pwconv_kernel(dev, g, ci, co, act, tile, dtype):
    x = _r((g, ci), dev, dtype)
    w = _r((ci, co), dev, dtype, ci ** -0.5)
    b = _r((co,), dev, dtype, 0.5)
    got = pwconv.pwconv(x, w, b, activation=act, block_g=tile[0],
                        block_co=tile[1], block_ci=tile[2])
    want = pwconv.pwconv_plain(x, w, b, activation=act)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize(
    "b,h,w,ci,c,co,stride,expand,residual,dw_act,act,tile", [
        (2, 9, 9, 12, 12, 20, 1, False, False, "relu6", "relu6", None),
        (1, 11, 7, 10, 10, 70, 2, False, False, "relu", "gelu", (3, 2, 4)),
        (2, 8, 8, 16, 16, 16, 1, False, True, "silu", None, (1, 1, 1)),
        (2, 8, 8, 8, 48, 8, 1, True, True, "relu6", None, None),
        (1, 9, 9, 6, 36, 10, 2, True, False, "gelu", "relu", (2, 5, 7)),
        (2, 7, 7, 5, 30, 5, 1, True, True, "silu", "silu", (7, 7, 30)),
    ])
def test_separable_fused_kernel(dev, b, h, w, ci, c, co, stride, expand,
                                residual, dw_act, act, tile, dtype):
    x_raw = _r((b, h, w, ci), dev, dtype)
    x = ref.pad_same(x_raw, 3, 3, stride)
    ew = _r((ci, c), dev, dtype, ci ** -0.5) if expand else None
    f, dwb = _r((3, 3, c), dev, dtype, 1 / 3), _r((c,), dev, dtype, 0.5)
    pw, pwb = _r((c, co), dev, dtype, c ** -0.5), _r((co,), dev, dtype, 0.5)
    res = x_raw if residual else None
    kw = dict(expand_w=ew, stride=stride, dw_activation=dw_act,
              activation=act)
    blocks = {}
    if tile is not None:
        blocks = dict(slab_h=tile[0], tile_w=tile[1], block_c=tile[2],
                      block_co=min(co, 64))
    got = sf.separable_fused(x, f, pw, dwb, pwb, res, **kw, **blocks)
    want = sf.separable_fused_plain(x, f, pw, dwb, pwb, res, **kw)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("budget", [64, 600, 232_448])
def test_ops_separable_fused_degrades_by_budget(dev, budget):
    x = _r((1, 8, 8, 16), dev, torch.float32)
    ew = _r((16, 96), dev, torch.float32, 0.25)
    f, pw = _r((3, 3, 96), dev, torch.float32, 1 / 3), \
        _r((96, 16), dev, torch.float32, 0.1)
    got = ops.separable_fused(x, f, pw, residual=x, expand_w=ew,
                              smem_budget=budget)
    want = ops.separable_fused(x, f, pw, residual=x, expand_w=ew,
                               impl="torch")
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("fused", (None, False))
@pytest.mark.parametrize("arch", ("v1", "v2"))
def test_network_launches_the_planned_kernels(dev, arch, fused):
    spec = getattr(network, f"mobilenet_{arch}_spec")(0.5)
    params = network.init_network(spec, seed=0, device=dev)
    x = _r((2, 32, 32, spec.c_in), dev, torch.float32)
    pol = KernelPolicy(fused=fused)
    plan = network.plan_network(spec, x.shape, policy=pol)
    reset_launch_counts()
    y = network.execute_network(spec, params, x, policy=pol)
    torch.cuda.synchronize(dev)
    hist = plan.segment_histogram()
    assert launch_counts() == {
        "dwconv2d": hist.get("dw", 0), "pwconv": hist.get("pw", 0),
        "separable_fused2": hist.get("fused2", 0),
        "separable_fused3": hist.get("fused3", 0)}
    want = network.execute_network(
        spec, params, x, policy=KernelPolicy(impl="torch", fused=fused))
    assert rel_err(y, want) <= 1e-4


def test_kernel_refuses_an_uncompiled_dtype_pair(dev):
    x = _r((1, 6, 6, 8), dev, torch.float32)
    with pytest.raises(ValueError, match="no kernel for stream"):
        dwconv2d.dwconv2d(x, _r((3, 3, 8), dev, torch.float32),
                          out_dtype=torch.bfloat16)
