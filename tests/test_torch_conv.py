"""keystone_tpu_torch's convolution nodes against the JAX package's: the
Convolver in each impl, its box sums, the Pooler's window geometry, the
rectifier, the fused node, ``conv2d_separable``, ``optimize`` and
``rewrite_nodes`` — the same numpy-seeded inputs through both packages.

Tolerances: float32 products and sums taken in another order, 1e-5 of
max|out| (the two packages read about 1e-7 to 1e-6); data movement and
max pooling, exactly."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keystone_tpu.core import fusion as j_fusion  # noqa: E402
from keystone_tpu.observe import events as j_events  # noqa: E402
from keystone_tpu.ops import images as j_images  # noqa: E402
from keystone_tpu.plan import passes as j_passes  # noqa: E402
from keystone_tpu.utils import images as j_utils  # noqa: E402
from keystone_tpu_torch import convert  # noqa: E402
from keystone_tpu_torch.core import fusion  # noqa: E402
from keystone_tpu_torch.observe import events, metrics  # noqa: E402
from keystone_tpu_torch.ops import images, linear  # noqa: E402
from keystone_tpu_torch.plan import passes  # noqa: E402
from keystone_tpu_torch.utils import images as utils  # noqa: E402

TOL = 1e-5  # of max|out|


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _conv_inputs(seed, n, h, w, c, k, f, pixels=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    if pixels:
        x = rng.uniform(0, 255, size=(n, h, w, c)).astype(np.float32)
    filters = rng.normal(size=(f, k * k * c)).astype(np.float32)
    means = rng.normal(size=(k * k * c,)).astype(np.float32)
    return x, filters, means


def _f64_convolver(x, filters, means, k, norm, var_constant=10.0):
    """The Convolver's im2col schedule in float64: patches in (dy, dx, c)
    order, each normalized with the d − 1 variance, less the whitener
    means, times the filters."""
    n, h, w, c = x.shape
    p = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), (k, k), axis=(1, 2))
    p = p.transpose(0, 1, 2, 4, 5, 3).reshape(n, h - k + 1, w - k + 1, k * k * c)
    if norm:
        mu = p.mean(-1, keepdims=True)
        var = ((p - mu) ** 2).sum(-1, keepdims=True) / max(p.shape[-1] - 1, 1)
        p = (p - mu) / np.sqrt(var + var_constant)
    if means is not None:
        p = p - means.astype(np.float64)
    return p @ filters.astype(np.float64).T


def test_f64_convolver_is_the_reference_schedule():
    """The float64 evaluation that names a failing side agrees with both
    packages at the random-patch workload's pixel-scale case."""
    x, filters, means = _conv_inputs(102, 3, 32, 32, 3, 6, 64, True)
    exact = _f64_convolver(x, filters, means, 6, True)
    want = np.asarray(j_images.Convolver(filters=jnp.asarray(filters),
                                         whitener_means=jnp.asarray(means),
                                         patch_size=6)(jnp.asarray(x)))
    got = convert.convolver(filters, means, device="cpu", patch_size=6)(torch.from_numpy(x))
    assert _rel(want, exact) <= TOL
    assert _rel(got.numpy(), exact) <= TOL


@pytest.mark.parametrize("impl", ["auto", "conv", "xla"])
@pytest.mark.parametrize(
    "h,w,c,k,f,norm,whiten,pixels",
    [
        (32, 32, 3, 6, 64, True, True, True),  # the random-patch workload's shape
        (32, 32, 3, 6, 64, True, False, False),
        (28, 28, 1, 5, 32, False, False, False),  # a plain convolution
        (17, 19, 3, 4, 20, True, True, False),  # not square, even kernel
    ],
)
def test_convolver_matches_jax(impl, h, w, c, k, f, norm, whiten, pixels):
    x, filters, means = _conv_inputs(h + k + f, 3, h, w, c, k, f, pixels)
    kw = dict(patch_size=k, normalize_patches=norm, impl=impl)
    want = np.asarray(j_images.Convolver(
        filters=jnp.asarray(filters), whitener_means=jnp.asarray(means) if whiten else None,
        **kw)(jnp.asarray(x)))
    node = convert.convolver(filters, means if whiten else None, device="cpu", **kw)
    got = node(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, h - k + 1, w - k + 1, f)
    err = _rel(got.numpy(), want)
    if err > TOL:  # name the side that left float32: each against float64
        exact = _f64_convolver(x, filters, means if whiten else None, k, norm)
        pytest.fail(f"port vs JAX {err:.3g} > {TOL}; port vs float64 "
                    f"{_rel(got.numpy(), exact):.3g}, JAX vs float64 {_rel(want, exact):.3g}")


def test_convolver_impls_agree():
    """The conv algebra against im2col in the port itself, at the JAX
    package's own 2e-4 absolute on unit-normal inputs
    (``tests/test_conv_fusion.py``)."""
    x, filters, means = _conv_inputs(0, 3, 32, 32, 3, 6, 64)
    common = dict(filters=torch.from_numpy(filters), whitener_means=torch.from_numpy(means),
                  patch_size=6)
    ref = images.Convolver(impl="xla", **common)(torch.from_numpy(x))
    for impl in ("auto", "conv"):
        out = images.Convolver(impl=impl, **common)(torch.from_numpy(x))
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


def test_unknown_impls_raise_the_reference_text():
    filters = torch.zeros((4, 27))
    with pytest.raises(ValueError, match=r"expected auto\|conv\|xla"):
        images.Convolver(filters=filters, patch_size=3, impl="fused")(torch.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError, match=r"expected auto\|unfused"):
        images.FusedConvRectifyPool(filters=filters, patch_size=3, impl="pallas")(
            torch.zeros((1, 8, 8, 3)))


def test_box_sums_are_exact_adds_at_pixel_scale():
    """The patch sums and sums of squares behind mu and sigma, at pixel
    scale (sums near 1.8e6), against float64 and the JAX package's
    ``reduce_window``: f32 adds, no TF32 and no integral image."""
    x = np.random.default_rng(3).uniform(0, 255, size=(4, 32, 32)).astype(np.float32)
    for v in (x, x * x):
        got = images._box_sum(torch.from_numpy(v), 6).numpy()
        exact = np.lib.stride_tricks.sliding_window_view(v.astype(np.float64), (6, 6),
                                                         axis=(1, 2)).sum(axis=(-1, -2))
        jax_sum = np.asarray(jax.lax.reduce_window(jnp.asarray(v), 0.0, jax.lax.add,
                                                   (1, 6, 6), (1, 1, 1), "VALID"))
        assert got.shape == (4, 27, 27)
        assert _rel(got, exact) <= 1e-6
        assert _rel(got, jax_sum) <= 1e-6


def test_flat_patches_match_jax():
    """Flat patches at pixel scale: the one-pass variance s2 − s1·mu
    cancels to about 0 (the clamp keeps it from going below), so sigma is
    sqrt(var_constant) and every output finite."""
    x = np.full((2, 10, 10, 3), 171.25, np.float32)
    x[1, 5:] = 3.5
    filters = np.random.default_rng(4).normal(size=(5, 27)).astype(np.float32)
    out = images.Convolver(filters=torch.from_numpy(filters), patch_size=3)(torch.from_numpy(x))
    want = np.asarray(j_images.Convolver(filters=jnp.asarray(filters), patch_size=3)(jnp.asarray(x)))
    assert torch.isfinite(out).all()
    assert _rel(out.numpy(), want) <= TOL


def test_precision_scopes_the_cudnn_flag(monkeypatch):
    """cuDNN reads its own TF32 flag: a Convolver asking for less than full
    f32 turns it on for its convolution and restores it; None and
    "highest" keep it off, and oneDNN's convolution stays IEEE. The flags
    are read through the ``fp32_precision`` API the scope sets them by
    (torch's legacy getters refuse a state the new API wrote)."""
    seen = []
    conv2d = torch.nn.functional.conv2d
    b = torch.backends

    def spy(*a, **kw):
        seen.append((b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision,
                     b.mkldnn.conv.fp32_precision))
        return conv2d(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.delenv("KEYSTONE_MATMUL_PRECISION", raising=False)
    before = torch.backends.cudnn.allow_tf32
    filters = torch.ones((2, 12))
    for precision, cuda in ((None, "ieee"), ("highest", "ieee"), ("high", "tf32"),
                            ("default", "tf32")):
        seen.clear()
        images.Convolver(filters=filters, patch_size=2, precision=precision)(torch.ones((1, 5, 5, 3)))
        assert seen == [(cuda, cuda, "ieee")], precision
        assert torch.backends.cudnn.allow_tf32 == before
    seen.clear()
    utils.conv2d_separable(torch.ones((1, 5, 5, 2)), [1.0, 2.0], [1.0])
    assert seen == [("ieee", "ieee", "ieee")] * 2
    assert torch.backends.cudnn.allow_tf32 == before


def test_precision_scopes_do_not_interleave_across_threads():
    """Two threads' scopes run one after the other: a full-f32 scope that
    starts while a TF32 scope is open waits for it, sees the flag off, and
    the flag ends as it began (interleaved, the second scope would save
    the first's TF32 and restore it)."""
    import threading

    from keystone_tpu_torch.ops.linear import _matmul_precision

    before = torch.backends.cudnn.allow_tf32
    opened, release, entered = threading.Event(), threading.Event(), threading.Event()
    seen = []

    def tf32_scope():
        with _matmul_precision("high"):
            opened.set()
            release.wait(10)

    def f32_scope():
        with _matmul_precision(None):
            entered.set()
            seen.append(torch.backends.cudnn.conv.fp32_precision)

    a = threading.Thread(target=tf32_scope)
    a.start()
    assert opened.wait(10)
    b = threading.Thread(target=f32_scope)
    b.start()
    try:
        assert not entered.wait(0.2)  # the open scope holds the flags
    finally:
        release.set()
        a.join(10)
        b.join(10)
    assert seen == ["ieee"]
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("kx,ky", [(3, 5), (4, 2), (1, 6), (7, 7)])
def test_conv2d_separable_matches_jax(kx, ky):
    """Odd and even kernels (the asymmetric pad) and the kernel reversal."""
    rng = np.random.default_rng(kx * 10 + ky)
    x = rng.normal(size=(2, 13, 11, 3)).astype(np.float32)
    a, b = rng.normal(size=kx).astype(np.float32), rng.normal(size=ky).astype(np.float32)
    got = utils.conv2d_separable(torch.from_numpy(x), a, b)
    want = np.asarray(j_utils.conv2d_separable(jnp.asarray(x), a, b))
    assert tuple(got.shape) == want.shape == x.shape
    assert _rel(got.numpy(), want) <= TOL


def test_windower_and_normalize_patch_rows_match_jax():
    x = np.random.default_rng(5).uniform(0, 255, size=(3, 12, 12, 3)).astype(np.float32)
    for stride, size in ((1, 6), (2, 4), (5, 5)):
        got = images.Windower(stride=stride, window_size=size)(torch.from_numpy(x))
        want = np.asarray(j_images.Windower(stride=stride, window_size=size)(jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), want)
    flat = images.ImageVectorizer()(images.Windower()(torch.from_numpy(x)))
    for vc in (10.0, 0.5):
        got = images.normalize_patch_rows(flat, vc)
        want = np.asarray(j_images.normalize_patch_rows(jnp.asarray(flat.numpy()), vc))
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("pool_fn", ["sum", "max", "mean"])
@pytest.mark.parametrize(
    "hw,stride,size,pools",
    [
        ((27, 27), 13, 14, (2, 2)),  # the workloads' map: pad 0, pools of 14 at 13
        ((12, 12), 3, 4, (4, 4)),  # pad 1: the last window truncated
        ((13, 10), 4, 5, (3, 2)),  # pad 2 on H, 1 on W
        ((10, 10), 3, 2, (3, 3)),  # a negative pad: the map's tail is never pooled
        ((5, 7), 2, 6, (1, 2)),  # windows larger than the map
    ],
)
def test_pooler_matches_jax(pool_fn, hw, stride, size, pools):
    x = np.random.default_rng(sum(hw) + size).normal(size=(2,) + hw + (3,)).astype(np.float32)
    got = images.Pooler(stride=stride, pool_size=size, pool_fn=pool_fn)(torch.from_numpy(x))
    want = np.asarray(j_images.Pooler(stride=stride, pool_size=size, pool_fn=pool_fn)(
        jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (2,) + pools + (3,)
    if pool_fn == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _rel(got.numpy(), want) <= TOL


def test_pooler_pixel_fn_and_rectifier_match_jax():
    x = np.random.default_rng(6).normal(size=(2, 9, 9, 4)).astype(np.float32)
    got = images.Pooler(stride=2, pool_size=3, pool_fn="max", pixel_fn=torch.abs)(torch.from_numpy(x))
    want = j_images.Pooler(stride=2, pool_size=3, pool_fn="max", pixel_fn=jnp.abs)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for max_val, alpha in ((0.0, 0.0), (0.0, 0.25), (-0.5, 0.1)):
        got = images.SymmetricRectifier(max_val=max_val, alpha=alpha)(torch.from_numpy(x))
        want = j_images.SymmetricRectifier(max_val=max_val, alpha=alpha)(jnp.asarray(x))
        assert tuple(got.shape) == (2, 9, 9, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["auto", "unfused"])
@pytest.mark.parametrize("pool_fn", ["sum", "max", "mean"])
def test_fused_node_matches_jax(impl, pool_fn):
    x, filters, means = _conv_inputs(7, 2, 14, 15, 3, 4, 16)
    kw = dict(patch_size=4, alpha=0.1, pool_stride=4, pool_size=5, pool_fn=pool_fn)
    want = np.asarray(j_images.FusedConvRectifyPool(
        filters=jnp.asarray(filters), whitener_means=jnp.asarray(means), impl=impl,
        **kw)(jnp.asarray(x)))
    node = convert.fused_conv_rectify_pool(filters, means, device="cpu", impl=impl, **kw)
    got = node(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 3, 3, 32)
    assert _rel(got.numpy(), want) <= TOL
    chain = (images.Convolver(filters=torch.from_numpy(filters),
                              whitener_means=torch.from_numpy(means), patch_size=4)
             >> images.SymmetricRectifier(alpha=0.1)
             >> images.Pooler(stride=4, pool_size=5, pool_fn=pool_fn))
    assert _rel(got.numpy(), chain(torch.from_numpy(x)).numpy()) <= TOL


def _pipes(pkg, filters, backend):
    conv = pkg.Convolver(filters=backend(filters), patch_size=3)
    return {
        "sum": conv >> pkg.SymmetricRectifier(alpha=0.1) >> pkg.Pooler(stride=3, pool_size=4)
        >> pkg.ImageVectorizer(),
        "max": conv >> pkg.SymmetricRectifier() >> pkg.Pooler(stride=3, pool_size=4, pool_fn="max"),
        "pixel_fn": conv >> pkg.SymmetricRectifier() >> pkg.Pooler(
            stride=3, pool_size=4, pixel_fn=abs),
        "highest": pkg.Convolver(filters=backend(filters), patch_size=3, precision="highest")
        >> pkg.SymmetricRectifier() >> pkg.Pooler(stride=3, pool_size=4),
        "xla": pkg.Convolver(filters=backend(filters), patch_size=3, impl="xla")
        >> pkg.SymmetricRectifier() >> pkg.Pooler(stride=3, pool_size=4),
        "two": conv >> pkg.SymmetricRectifier() >> pkg.Pooler(stride=3, pool_size=4)
        >> pkg.ImageVectorizer() >> pkg.ImageVectorizer(),
    }


def test_rewrite_nodes_and_optimize_match_jax(tmp_path):
    """The same windows rewritten with the same decision records as the
    JAX package's ``rewrite_nodes``; ``optimize`` counts
    ``fusion_rewrites`` by rule, emits one ``optimize`` event, keeps the
    numbers and returns an input with nothing to rewrite as itself."""
    filters = np.random.default_rng(8).normal(size=(4, 27)).astype(np.float32)
    ours = _pipes(images, filters, torch.from_numpy)
    theirs = _pipes(j_images, filters, jnp.asarray)
    x = np.random.default_rng(9).normal(size=(2, 12, 12, 3)).astype(np.float32)
    counter = metrics.get_registry().counter("fusion_rewrites", rule="conv_rectify_pool")
    plan_counter = metrics.get_registry().counter("plan_rewrites", rule="conv_rectify_pool")
    for name, pipe in ours.items():
        out, decisions = passes.rewrite_nodes(pipe.nodes)
        j_out, j_decisions = j_passes.rewrite_nodes(theirs[name].nodes)
        assert decisions == j_decisions, name
        assert [type(n).__name__ for n in out] == [type(n).__name__ for n in j_out]
        before, plan_before = counter.value, plan_counter.value
        with events.run(str(tmp_path / name)) as log:
            opt = fusion.optimize(pipe)
        assert plan_counter.value == plan_before  # the planner did not run
        if not decisions:
            assert opt is pipe and counter.value == before
            continue
        assert counter.value == before + len(decisions)
        rec = [e for e in log.records if e["event"] == "optimize"]
        assert [(e["rule"], e["rewrites"], e["nodes_before"], e["nodes_after"]) for e in rec] == [
            ("conv_rectify_pool", 1, len(pipe.nodes), len(out))]
        assert isinstance(opt.nodes[0], images.FusedConvRectifyPool)
        want = np.asarray(j_fusion.optimize(theirs[name])(jnp.asarray(x)))
        assert _rel(opt(torch.from_numpy(x)).numpy(), want) <= TOL
    conv = ours["sum"].nodes[0]
    assert fusion.optimize(conv) is conv
    assert j_events.node_label(theirs["sum"].nodes[0], 0) == events.node_label(conv, 0)


def test_planner_applies_the_conv_rule_and_counts_plan_rewrites():
    from keystone_tpu_torch import plan

    filters = np.random.default_rng(10).normal(size=(4, 27)).astype(np.float32)
    pipe = _pipes(images, filters, torch.from_numpy)["sum"]
    counter = metrics.get_registry().counter("plan_rewrites", rule="conv_rectify_pool")
    before = counter.value
    x = np.random.default_rng(11).normal(size=(6, 12, 12, 3)).astype(np.float32)
    p = plan.plan_pipeline(pipe, sample=x, device=torch.device("cpu"))
    assert [type(pn.op).__name__ for pn in p.prefix] == ["FusedConvRectifyPool", "ImageVectorizer"]
    assert p.prefix[0].rewritten_from == ("00:Convolver", "01:SymmetricRectifier", "02:Pooler")
    assert counter.value == before + 1
    torch.testing.assert_close(plan.execute(pipe, x, device=torch.device("cpu")),
                               pipe(torch.from_numpy(x)), rtol=0, atol=1e-4)


# every process-wide float32 precision flag as (backend, op), parents
# first: a parent's set writes into its operators
FP32_FLAGS = [("generic", "all"), ("cuda", "all"), ("mkldnn", "all"), ("cuda", "matmul"),
              ("cuda", "conv"), ("cuda", "rnn"), ("mkldnn", "matmul"), ("mkldnn", "conv"),
              ("mkldnn", "rnn")]


def _fp32_flags():
    return [torch._C._get_fp32_precision_getter(*f) for f in FP32_FLAGS]


def _fp32_state():
    """The whole float32 precision state: torch's legacy matmul-precision
    string, which torch keeps apart from the flags, then every flag."""
    return torch.get_float32_matmul_precision(), _fp32_flags()


@contextlib.contextmanager
def _fp32_state_restored():
    """Put the whole float32 precision state back as it was found: the
    legacy string first, since its setter writes flags (``medium`` sets
    oneDNN's matmul to bf16), then the nine flags over it."""
    legacy, saved = _fp32_state()
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(legacy)
        for flag, value in zip(FP32_FLAGS, saved):
            torch._C._set_fp32_precision_setter(*flag, value)


@pytest.fixture
def restore_fp32_flags():
    """Put the whole float32 precision state back as the test found it."""
    with _fp32_state_restored():
        yield


def _set_adverse(kind):
    b = torch.backends
    if kind == "onednn_conv_bf16":  # 2.4e-3 to 4e-3 of max on a CPU with AMX-BF16
        b.mkldnn.conv.fp32_precision = "bf16"
    elif kind == "onednn_matmul_bf16":
        b.mkldnn.matmul.fp32_precision = "bf16"
    elif kind == "generic_bf16":
        b.fp32_precision = "bf16"
    elif kind == "tf32_everywhere":
        b.fp32_precision = "tf32"
    elif kind == "mixed_apis":  # the legacy getters raise in this state
        torch.set_float32_matmul_precision("medium")
        b.mkldnn.conv.fp32_precision = "bf16"
        b.cudnn.conv.fp32_precision = "ieee"
    else:
        raise AssertionError(kind)


@pytest.mark.parametrize(
    "kind", ["onednn_conv_bf16", "onednn_matmul_bf16", "generic_bf16", "tf32_everywhere",
             "mixed_apis"])
def test_full_f32_scope_holds_under_adverse_precision_state(kind, monkeypatch, restore_fp32_flags):
    """``precision=None`` is full f32 whatever float32 precision state the
    process was left in: the Convolver (the random-patch workload's case)
    and ``conv2d_separable`` hold 1e-5 of max against the JAX package
    with each adverse flag set, and the scope leaves the flags as it
    found them."""
    monkeypatch.delenv("KEYSTONE_MATMUL_PRECISION", raising=False)
    x, filters, means = _conv_inputs(102, 3, 32, 32, 3, 6, 64, True)
    want = np.asarray(j_images.Convolver(filters=jnp.asarray(filters),
                                         whitener_means=jnp.asarray(means),
                                         patch_size=6)(jnp.asarray(x)))
    a, b = np.random.default_rng(1).normal(size=(2, 7)).astype(np.float32)
    want_sep = np.asarray(j_utils.conv2d_separable(jnp.asarray(x), a, b))
    _set_adverse(kind)
    adverse = _fp32_flags()
    got = convert.convolver(filters, means, device="cpu", patch_size=6)(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(utils.conv2d_separable(torch.from_numpy(x), a, b).numpy(), want_sep) <= TOL
    assert _fp32_flags() == adverse


def test_fixture_puts_back_the_whole_precision_state():
    """``restore_fp32_flags`` and ``test_torch_flash.fresh_state``'s scope
    leave no precision state behind: after the ``mixed_apis`` state is set
    and undone, the legacy string and every flag read as before, and a
    CPU float32 product holds 1e-6 of max against float64 (oneDNN's bf16
    reads about 1e-3)."""
    before = _fp32_state()
    with _fp32_state_restored():
        _set_adverse("mixed_apis")
    with linear._matmul_precision("highest"):  # what fresh_state enters
        pass
    assert _fp32_state() == before
    a, b = np.random.default_rng(3).normal(size=(2, 256, 256)).astype(np.float32)
    got = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    assert _rel(got, a.astype(np.float64) @ b.astype(np.float64)) <= 1e-6
