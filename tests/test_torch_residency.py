"""``serve/residency.py``, the port's one byte definition, against the
reference's on the CPU (olmo-1b ``.smoke()``): ``report`` equals JAX's
key for key, exactly, on packed and fake-quant params and on full, int8,
int4 and per-layer mixed caches, contiguous and paged.  The reference's
caches are built in its unrolled layout and in its default (stacked, or
bucketed where the bits mix), which hold the same buffers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro.serve import residency as jres  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (EngineSpec, ServeEngine, kv_cache,  # noqa: E402
                               pack_params, packing, paging,
                               quantize_for_serving, residency)

B, MAX_SEQ, N_PAGES, PAGE = 3, 40, 11, 16
CACHES = {"full": None, "int8": 8, "int4": 4, "8-4": {"pat0": [8, 4]},
          "16-8": {"pat0": [16, 8]}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    jpol, tpol = jtf.build_policy(jcfg), ttf.build_policy(cfg)
    jtake = jk.select_for_budget(jpol, jk.synthetic_gains(jpol), 0.7).take
    ttake = tk.select_for_budget(tpol, tk.synthetic_gains(tpol), 0.7).take
    arrays = {"uniform": (jpol.as_arrays(), tpol.as_arrays()),
              "mixed": (jpol.apply_selection(jtake).as_arrays(),
                        tpol.apply_selection(ttake).as_arrays())}
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "tparams": tparams,
            "arrays": arrays}


def _params(setup, policy, layout):
    """(JAX's serve params, the port's) in ``layout``."""
    ja, ta = setup["arrays"][policy]
    if layout == "packed":
        return (jpack(setup["jparams"], ja, setup["jcfg"]),
                pack_params(setup["tparams"], ta, setup["cfg"],
                            device="cpu"))
    return (jengine.quantize_for_serving(setup["jparams"], ja,
                                         setup["jcfg"]),
            quantize_for_serving(setup["tparams"], ta, setup["cfg"],
                                 device="cpu"))


def _caches(setup, bits, layout, plan):
    """(JAX's cache, the port's) at ``bits``, ``layout``."""
    if layout == "paged":
        return (jpaging.init_paged_cache(setup["jcfg"], B, MAX_SEQ, N_PAGES,
                                         PAGE, dtype=jnp.float32,
                                         cache_bits=bits, plan=plan),
                paging.init_paged_cache(setup["cfg"], B, MAX_SEQ, N_PAGES,
                                        PAGE, torch.float32, "cpu", bits))
    return (jkv.init_cache(setup["jcfg"], B, MAX_SEQ, dtype=jnp.float32,
                           cache_bits=bits, plan=plan),
            kv_cache.init_cache(setup["cfg"], B, MAX_SEQ, torch.float32,
                                "cpu", bits))


@pytest.mark.parametrize("layout", ["packed", "fake_quant"])
@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_weight_report_matches_jax(setup, policy, layout):
    """The weights' report and bf16 bytes equal JAX's; packing's
    resident_weight_bytes is the same number; the fake-quant layout keeps
    a byte a code (the reference's int4 container), so the packed layout
    is the smaller."""
    jp, tp = _params(setup, policy, layout)
    assert residency.report(tp) == jres.report(jp)
    assert residency.bf16_resident_bytes(tp) == jres.bf16_resident_bytes(jp)
    assert packing.resident_weight_bytes(tp) == residency.resident_bytes(tp)
    assert residency.per_device_bytes(tp) == residency.resident_bytes(tp)
    if layout == "fake_quant":
        packed = _params(setup, policy, "packed")[1]
        assert residency.resident_bytes(packed) < residency.resident_bytes(tp)
        assert packing.bf16_weight_bytes(packed) == \
            packing.bf16_weight_bytes(tp)


@pytest.mark.parametrize("plan", [None, "unrolled"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_cache_report_matches_jax(setup, cache, layout, plan):
    """report(params, cache) equals JAX's key for key, the paged keys
    included; the lengths and the block table are not counted."""
    jp, tp = _params(setup, "mixed", "packed")
    jc, tc = _caches(setup, CACHES[cache], layout, plan)
    want = jres.report(jp, jc)
    got = residency.report(tp, tc)
    assert got == want
    assert ("paged_page_bytes" in got) == (layout == "paged")
    assert got["resident_kv_bytes"] == residency.resident_bytes(tc.layers)
    if layout == "paged":
        assert (got["paged_page_bytes"] * N_PAGES + got["paged_slot_bytes"]
                == got["resident_kv_bytes"])


def test_mixed_cache_bytes_are_its_layers(setup):
    """A mixed cache's resident KV bytes are the sum of its layers' bytes
    in the uniform caches of their bits, strictly between the uniform int4
    and int8 totals; a cache that is not paged has no page bytes."""
    for layout in ("contiguous", "paged"):
        leaves = {b: [residency.resident_kv_bytes(layer)
                      for layer in _caches(setup, b, layout,
                                           "unrolled")[1].layers["pat"]]
                  for b in (8, 4)}
        mixed = _caches(setup, CACHES["8-4"], layout, "unrolled")[1]
        got = residency.resident_kv_bytes(mixed)
        assert got == leaves[8][0] + leaves[4][1]
        assert sum(leaves[4]) < got < sum(leaves[8])
    with pytest.raises(ValueError, match="not a paged cache"):
        residency.paged_page_bytes(_caches(setup, 8, "contiguous",
                                           None)[1])


@pytest.mark.parametrize("weights", ["packed", "fake_quant"])
def test_engine_residency(setup, weights):
    """ServeEngine.residency is report(params, cache); the roofline is the
    weights plus one request's share of the cache."""
    _, tp = _params(setup, "mixed", weights)
    engine = ServeEngine(setup["cfg"], tp, setup["arrays"]["mixed"][1],
                         MAX_SEQ, EngineSpec(weights=weights,
                                             cache="quantized",
                                             cache_bits=CACHES["8-4"]),
                         device="cpu")
    cache = engine.new_cache(B)
    got = engine.residency(cache)
    assert got == residency.report(tp, cache)
    assert engine.residency() == residency.report(tp)
    assert got["bytes_per_token_roofline"] == (
        got["resident_weight_bytes"] + got["resident_kv_bytes"] / B)
