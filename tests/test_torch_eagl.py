"""EAGL in the port against the JAX package on the CPU: the histogram and
entropy (JAX side in interpret mode and through its oracle), the member
tensors each unit reads, and the gains on olmo-1b ``.smoke()`` params
carried across with ``from_jax_params``.

Tolerances: counts exact; entropies and gains within 1e-6 relative (the
counts are equal, so only float32 rounding of the p*log2(p) sum differs);
the knapsack ``take`` sets equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.metrics import eagl as teagl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

REL = 1e-6


@pytest.fixture(scope="module")
def model():
    jcfg = configs.get_config("olmo-1b").smoke()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return (jtf.build_policy(jcfg), jparams,
            ttf.build_policy(olmo_1b.config().smoke()), tparams)


@pytest.mark.parametrize("n", [100, 8192, 50_001])
@pytest.mark.parametrize("n_bins", [4, 16, 256])
def test_histogram_matches_jax(n, n_bins):
    """Codes below 0 and at or past n_bins (the TPU wrapper's sentinel)
    fall in no bin; every count is JAX's."""
    codes = np.random.default_rng(n + n_bins).integers(
        -2, n_bins + 2, size=n).astype(np.int32)
    got = tops.histogram(torch.as_tensor(codes), n_bins)
    assert got.dtype == torch.float32 and got.shape == (n_bins,)
    for impl in ("interpret", "ref"):
        want = jops.histogram(jnp.asarray(codes), n_bins, impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) == float(((codes >= 0) & (codes < n_bins)).sum())


def test_entropy_bits_matches_jax():
    codes = np.random.default_rng(0).integers(0, 16, 10_000).astype(np.int32)
    got = float(tops.entropy_bits(torch.as_tensor(codes), 16))
    for impl in ("interpret", "ref"):
        want = float(jops.entropy_bits(jnp.asarray(codes), 16, impl=impl))
        assert got == pytest.approx(want, rel=REL)


def test_entropy_empty_bins_add_exactly_zero():
    """Uniform over 4 of 16 bins is exactly 2 bits; all in one bin is 0."""
    codes = torch.as_tensor(np.tile(np.arange(4), 256).astype(np.int32))
    assert float(tops.entropy_bits(codes, 16)) == 2.0
    assert float(tref.entropy_from_counts(torch.tensor([0.0, 9.0, 0.0]))) \
        == 0.0


@pytest.mark.parametrize("bits", [4.0, 2.0])
def test_unit_entropy_matches_jax(bits):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(64, 48)) * 0.3).astype(np.float32)
    step = np.float32(0.1)
    got = float(teagl.unit_entropy(torch.as_tensor(w), step, bits))
    for impl in ("interpret", "ref"):
        want = float(jeagl.unit_entropy(jnp.asarray(w), jnp.float32(step),
                                        bits, impl=impl))
        assert got == pytest.approx(want, rel=REL)


def test_fetch_unit_tensor_matches_jax(model):
    jpol, jparams, tpol, tparams = model
    for ju, tu in zip(jpol.units, tpol.units, strict=True):
        for path in tu.tensors:
            tw, ts = ttf.fetch_unit_tensor(tparams, tu, path)
            jw, js = jtf.fetch_unit_tensor(jparams, ju, path)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(KeyError, match="step"):
        ttf.fetch_unit_tensor({"x": {"w": tparams["embed"]["w"]}},
                              tpol.units[0], ("x", "w"))


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_eagl_gains_and_take_match_jax(model, impl):
    jpol, jparams, tpol, tparams = model
    got = teagl.eagl_gains(
        tpol, lambda u, t: ttf.fetch_unit_tensor(tparams, u, t))
    want = jeagl.eagl_gains(
        jpol, lambda u, t: jtf.fetch_unit_tensor(jparams, u, t), impl=impl)
    assert list(got) == list(want)
    assert len(got) == 4 * olmo_1b.config().smoke().n_repeats
    for name, g in got.items():
        assert g == pytest.approx(want[name], rel=REL), name
    takes = []
    for budget in (0.5, 0.7, 0.75):
        tt = tk.select_for_budget(tpol, got, budget_frac=budget).take
        jt = jk.select_for_budget(jpol, want, budget_frac=budget).take
        assert tt == jt, budget
        takes.append(sum(tt.values()))
    assert takes[0] < takes[1] < len(got)   # the budgets pick different mixes
