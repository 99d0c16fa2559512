"""Serving what the joint knapsack selects, held against the JAX package on
the CPU (olmo-1b ``.smoke()``, float32): per-layer KV-cache bits
(``cache_bits={group: per-layer}``, 16 meaning a full-dtype layer) over
contiguous and paged caches, the fake-quant weight layout
(``quantize_for_serving``), and chip_smoke.py's ``joint`` phase rehearsed.

Tolerances: prefill logits within 1e-4 * max|logit| of JAX's (float32;
the engines differ in summation order only), as tests/test_torch_serve.py
holds them; cached K/V codes of int8 layers bit for bit and their scales
within 1e-6 relative; int4 layers within one code step, as
``test_int4_cache_ladder`` holds them (a rounding tie that ulp-level
differences decide flips a code: ROADMAP Queue 3); full-dtype layers'
K/V within 1e-4 * max|K|; tokens exactly.  Free-running token equality
with JAX is asserted only where no layer is int4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import EngineSpec as JSpec  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import kv_quant  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,  # noqa: E402
                               EngineSpec, Request, ServeEngine, pack_params,
                               quantize_for_serving)

MAX_SEQ = 64
REL = 1e-4
SCALE_REL = 1e-6
MIXED = {"8-4": {"pat0": [8, 4]}, "16-8": {"pat0": [16, 8]}}
LAYOUTS = ["contiguous", "paged"]


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
            "arrays": arrays, "jengines": {}, "jfake": {}}


def _jax_fake(setup, policy):
    if policy not in setup["jfake"]:
        setup["jfake"][policy] = jengine.quantize_for_serving(
            setup["jparams"], setup["arrays"][policy][0], setup["jcfg"])
    return setup["jfake"][policy]


def _jax_engine(setup, policy, weights, cache, bits, layout="contiguous"):
    """JAX's engine; packed params in the unrolled layout, whose cache is
    the port's per-layer list."""
    key = (policy, weights, cache, str(bits), layout)
    if key not in setup["jengines"]:
        ja = setup["arrays"][policy][0]
        params = (jpack(setup["jparams"], ja, setup["jcfg"],
                        layout="unrolled") if weights == "packed"
                  else _jax_fake(setup, policy))
        setup["jengines"][key] = JEngine(
            cfg=setup["jcfg"], params=params,
            policy_arrays=jax.tree.map(jnp.asarray, ja), ctx=local_context(),
            max_seq=MAX_SEQ, spec=JSpec(weights=weights, cache=cache,
                                        cache_bits=bits,
                                        cache_layout=layout))
    return setup["jengines"][key]


def _port_params(setup, policy, weights):
    ta = setup["arrays"][policy][1]
    build = pack_params if weights == "packed" else quantize_for_serving
    return build(setup["tparams"], ta, setup["cfg"], device="cpu")


def _port_engine(setup, policy, weights, cache, bits, layout="contiguous"):
    return ServeEngine(setup["cfg"], _port_params(setup, policy, weights),
                       setup["arrays"][policy][1], MAX_SEQ,
                       EngineSpec(weights=weights, cache=cache,
                                  cache_bits=bits, cache_layout=layout),
                       device="cpu")


def _prompt(seed=20, rows=1, n=12):
    return np.random.default_rng(seed).integers(0, 512, (rows, n)).astype(
        np.int32)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ----------------------------------------------------------- init_caches
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bits", [{"pat0": [8, 4]}, {"pat0": [16, 8]},
                                  {"other": [8, 8]}, 4],
                         ids=["8-4", "16-8", "missing-group", "uniform4"])
def test_init_caches_per_layer_bits(setup, bits, layout):
    """Each layer's leaf has the keys, shapes and dtypes of the reference's
    ``plan="unrolled"`` leaf at that layer's bits."""
    geom = (7, 16) if layout == "paged" else None
    want = jtf.init_caches(setup["jcfg"], 2, 32, cache_dtype=jnp.float32,
                           cache_bits=bits, page_geom=geom, plan="unrolled")
    got = ttf.init_caches(setup["cfg"], 2, 32, torch.float32, "cpu", bits,
                          page_geom=geom)
    assert len(got["pat"]) == len(want["pat"]) == setup["cfg"].n_repeats
    for r, (g, w) in enumerate(zip(got["pat"], want["pat"])):
        g, w = g["p0"], w["p0"]
        assert set(g) == set(w), r
        for k in g:
            assert tuple(g[k].shape) == tuple(w[k].shape), (r, k)
            assert _dtype_name(g[k]) == np.dtype(w[k].dtype).name, (r, k)


@pytest.mark.parametrize("bits,match", [
    ({"pat0": [8, 5]}, "4, 8 or 16"), (3, "4, 8 or 16"),
    ({"pat0": [8]}, "every layer")])
def test_init_caches_refuses_bad_bits(setup, bits, match):
    """A value other than 4, 8 or 16, or an array shorter than the group's
    layers, raises ValueError in both packages."""
    with pytest.raises(ValueError):
        jtf.init_caches(setup["jcfg"], 1, 16, cache_bits=bits,
                        plan="unrolled")
    with pytest.raises(ValueError, match=match):
        ttf.init_caches(setup["cfg"], 1, 16, torch.float32, "cpu", bits)


# ----------------------------------------------------- mixed-cache engines
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mix", list(MIXED))
def test_mixed_cache_prefill_matches_jax(setup, mix, layout):
    """Mixed 4/2 weights over a per-layer cache: JAX's first token and
    prefill logits, and each layer's spliced cache as JAX's at its bits
    (int8 codes bit for bit, int4 within one code step, full K/V within
    1e-4)."""
    bits = MIXED[mix]
    je = _jax_engine(setup, "mixed", "packed", "quantized", bits, layout)
    te = _port_engine(setup, "mixed", "packed", "quantized", bits, layout)
    prompt = _prompt(rows=2)
    lengths = np.array([12, 7], np.int32)
    jlast, jpre = je.prefill(jnp.asarray(prompt), jnp.asarray(lengths))
    tlast, tpre = te.prefill(torch.as_tensor(prompt),
                             torch.as_tensor(lengths))
    want = np.asarray(jlast)
    assert np.abs(tlast.numpy() - want).max() <= REL * np.abs(want).max()
    np.testing.assert_array_equal(tlast.numpy().argmax(-1), want.argmax(-1))
    splice = jpaging.splice_prefill if layout == "paged" else \
        jkv.splice_prefill
    jc = splice(je.new_cache(2), jpre, jnp.asarray(lengths))
    tc = te.splice_prefill(tpre, torch.as_tensor(lengths))
    p = "p" if layout == "paged" else ""
    for r, b in enumerate(bits["pat0"]):
        got = {k: v.numpy() for k, v in tc.layers["pat"][r]["p0"].items()}
        ref = {k: np.array(v)
               for k, v in jc.layers["pat"][r]["p0"].items()}
        assert set(got) == set(ref), r
        if b == 16:
            for k in (f"{p}k", f"{p}v"):
                assert np.abs(got[k] - ref[k]).max() <= \
                    REL * np.abs(ref[k]).max(), (r, k)
            continue
        for k in ("k_scale", f"{p}v_scale"):
            np.testing.assert_allclose(got[k], ref[k], rtol=SCALE_REL,
                                       atol=0, err_msg=f"{r} {k}")
        for kind in ("k", "v"):
            codes = f"{p}{kind}q"
            if b == 8:
                np.testing.assert_array_equal(got[codes], ref[codes],
                                              f"{r} {codes}")
                continue
            diff = np.abs(kv_quant.unpack4(torch.as_tensor(got[codes]),
                                           torch.int32).numpy()
                          - kv_quant.unpack4(torch.as_tensor(ref[codes]),
                                             torch.int32).numpy())
            assert diff.max() <= 1, (r, codes)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_full_and_int8_layers_greedy_match_jax(setup, layout):
    """With no int4 layer ([16, 8]) 16 greedy tokens equal JAX's."""
    bits = MIXED["16-8"]
    prompt = _prompt()
    want = np.asarray(_jax_engine(setup, "mixed", "packed", "quantized",
                                  bits, layout).generate(
        jnp.asarray(prompt), n_new=16))
    got = _port_engine(setup, "mixed", "packed", "quantized", bits,
                       layout).generate(prompt, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", ["packed", "fake_quant"])
@pytest.mark.parametrize("mix", list(MIXED))
def test_mixed_paged_generate_equals_contiguous(setup, mix, weights):
    """Paged generate equals contiguous generate token for token, batched
    with unequal prompts, each layer at its own cache bits."""
    toks = np.random.default_rng(9).integers(0, 512, (3, 20)).astype(
        np.int32)
    lengths = [20, 5, 17]
    want = _port_engine(setup, "mixed", weights, "quantized",
                        MIXED[mix]).generate(toks, 24, lengths=lengths)
    got = _port_engine(setup, "mixed", weights, "quantized", MIXED[mix],
                       "paged").generate(toks, 24, lengths=lengths)
    assert torch.equal(got, want)


@pytest.mark.parametrize("weights", ["packed", "fake_quant"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mix", list(MIXED))
def test_mixed_scheduler_equals_serial(setup, mix, layout, weights):
    """Five requests through two slots (evictions, re-admission onto a
    reused slot or recycled pages, and an identical prompt: a paged
    quantized engine shares it, the full-dtype layer of [16, 8] included)
    give each request's tokens of its serial run."""
    te = _port_engine(setup, "mixed", weights, "quantized", MIXED[mix],
                      layout)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).tolist() for n in (12, 19, 7, 12)]
    prompts.append(list(prompts[0]))
    reqs = [Request(uid=f"r{i}", prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (6, 9, 5, 7, 6)))]
    sched = ContinuousBatchingScheduler(te, n_slots=2)
    for req in reqs:
        sched.submit(req)
    done = sched.run()
    if layout == "paged":
        assert sched.registry.hits == 1          # r4, r0's prompt
    for req in reqs:
        solo = te.generate(np.asarray([req.prompt]), req.max_new_tokens)
        assert done[req.uid].tokens == solo[0].tolist(), req.uid


# --------------------------------------------------- the fake-quant layout
def _qnodes(tree):
    """(path, node) of each {'wq', 'scale', 'sa'} projection of a
    per-layer fake-quant tree."""
    for r, layer in enumerate(tree["pat"]):
        for blk in layer.values():
            for part in ("attn", "mlp"):
                for name, node in blk[part].items():
                    yield (r, part, name), node


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_quantize_for_serving_matches_jax(setup, policy):
    """Codes, scales and steps equal JAX's bit for bit (its int4 codes
    carried to int8); codes lie in their bits' signed range (2-bit in
    [-2, 1]) and equal the packed layout's codes unpacked, scales its
    per-channel scales."""
    ta = setup["arrays"][policy][1]
    got = quantize_for_serving(setup["tparams"], ta, setup["cfg"],
                               device="cpu")
    want = from_jax_params(jax.tree.map(np.asarray, _jax_fake(setup,
                                                               policy)),
                           device="cpu")
    packed = pack_params(setup["tparams"], ta, setup["cfg"], device="cpu")
    for k in ("wq", "scale"):
        assert torch.equal(got["embed"][k], want["embed"][k])
        assert torch.equal(got["embed"][k], packed["embed"][k])
    slots = ttf.slot_index(setup["cfg"])
    seen = set()
    for (r, part, name), node in _qnodes(got):
        ref = want["pat"][r]["p0"][part][name]
        assert set(node) == set(ref) == {"wq", "scale", "sa"}
        assert node["wq"].dtype == ref["wq"].dtype == torch.int8
        for k in node:
            assert torch.equal(node[k], ref[k]), (r, part, name, k)
        group, slot = slots[("pat", "p0", part, name)]
        b = int(ta[group][slot][r])
        seen.add(b)
        lo, hi = -(1 << (b - 1)), (1 << (b - 1)) - 1
        assert lo <= int(node["wq"].min()) and int(node["wq"].max()) <= hi
        p = packed["pat"][r]["p0"][part][name]
        codes = quant.unpack_codes_kmajor(p.wp, p.bits, torch.int8)[
            :p.k_dim]
        assert torch.equal(codes, node["wq"])
        assert torch.equal(p.scale, node["scale"].expand(p.n_dim))
    assert seen == ({4} if policy == "uniform" else {2, 4})


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_fake_quant_prefill_matches_jax(setup, policy):
    """Prefill logits within 1e-4 * max|logit| of JAX's fake-quant
    engine's."""
    prompt = np.random.default_rng(7).integers(0, 512, (2, 12)).astype(
        np.int32)
    lengths = np.array([12, 7], np.int32)
    want, _ = _jax_engine(setup, policy, "fake_quant", "full", 8).prefill(
        jnp.asarray(prompt), jnp.asarray(lengths))
    got, _ = _port_engine(setup, policy, "fake_quant", "full", 8).prefill(
        torch.as_tensor(prompt), torch.as_tensor(lengths))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("cache", ["full", "quantized"])
@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_fake_quant_greedy_matches_jax(setup, policy, cache):
    """16 greedy tokens equal JAX's fake-quant engine's over full and int8
    caches."""
    prompt = _prompt(seed=16 if policy == "uniform" else 17, rows=1)
    want = np.asarray(_jax_engine(setup, policy, "fake_quant", cache, 8)
                      .generate(jnp.asarray(prompt), n_new=16))
    te = _port_engine(setup, policy, "fake_quant", cache, 8)
    assert te.decode_params() is te.params
    np.testing.assert_array_equal(te.generate(prompt, 16).numpy(), want)


@pytest.mark.parametrize("cache,bits", [("full", 8), ("quantized", 8),
                                        ("quantized", 4),
                                        ("quantized", {"pat0": [8, 4]})],
                         ids=["full", "int8", "int4", "8-4"])
def test_fake_quant_equals_packed(setup, cache, bits):
    """The two layouts serve the same tokens: their codes are equal and on
    the CPU both dequantize codes * scale in float32 before the matmul."""
    toks = np.random.default_rng(6).integers(0, 512, (2, 16)).astype(
        np.int32)
    got = _port_engine(setup, "mixed", "fake_quant", cache, bits).generate(
        toks, 16, lengths=[10, 16])
    want = _port_engine(setup, "mixed", "packed", cache, bits).generate(
        toks, 16, lengths=[10, 16])
    assert torch.equal(got, want)


def test_spec_layout_agreement(setup):
    """``validate(cfg, params)`` refuses params of the other layout with
    the reference's message, in both directions; the engine checks it."""
    ta = setup["arrays"]["mixed"][1]
    packed = _port_params(setup, "mixed", "packed")
    fake = _port_params(setup, "mixed", "fake_quant")
    EngineSpec(weights="fake_quant").validate(setup["cfg"], fake)
    EngineSpec(weights="packed").validate(setup["cfg"], packed)
    for weights, params, have in (("fake_quant", packed, "packed"),
                                  ("packed", fake, "fake_quant")):
        for check in (lambda: EngineSpec(weights=weights).validate(
                          setup["cfg"], params),
                      lambda: ServeEngine(setup["cfg"], params, ta, MAX_SEQ,
                                          EngineSpec(weights=weights),
                                          device="cpu")):
            with pytest.raises(ValueError, match=f"in the '{have}' layout"):
                check()
    with pytest.raises(ValueError, match="'fake_quant' or 'packed'"):
        EngineSpec(weights="int4").validate()


# ------------------------------------------------------- chip_smoke joint
@pytest.fixture
def cpu_card(monkeypatch):
    """The "auto" path on CPU tensors: every kernel wrapper runs its plain
    version, each call counted in cuda.LAUNCHES (a packed 4/2-bit matmul
    counts as quant_matmul, which it launches on the card, and decode runs
    on the packed codes, as there); the card's clocks and memory calls are
    no-ops."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import cuda, ops, ref
    monkeypatch.setattr(ops, "use_kernel", lambda t, impl: impl == "auto")

    def counted(name, fn):
        def run(*a, **k):
            cuda.LAUNCHES[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(cuda, "lsq_fakequant", counted(
        "lsq_fakequant", lambda x, s, b: ref.lsq_fakequant_grouped(x, s, b)
        if isinstance(s, list) else ref.lsq_fakequant(x, s, b)))
    monkeypatch.setattr(cuda, "flash_attention", counted(
        "flash_attention", lambda q, k, v, causal=True: ops.flash_attention(
            q, k, v, causal, impl="ref")))
    monkeypatch.setattr(cuda, "kv_decode_attention", counted(
        "kv_decode_attention", ref.kv_cache_attention))
    monkeypatch.setattr(cuda, "paged_kv_decode_attention", counted(
        "paged_kv_decode_attention", ref.paged_kv_cache_attention))
    real = ops.packed_matmul

    def packed_matmul(x, p, impl="auto"):
        if p.bits != 8 and impl == "auto":
            cuda.LAUNCHES["quant_matmul"] += 1
        return real(x, p, impl)
    monkeypatch.setattr(ops, "packed_matmul", packed_matmul)
    # decode on the packed codes, as on the card (not the CPU's view)
    monkeypatch.setattr(ServeEngine, "decode_params", lambda self:
                        self.params)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_breakdown", lambda fn, top=20: (
        fn(), {"wall_ms": 1.0, "device_ms": 0.5, "idle_share": 0.5,
               "dtoh_copies": 0, "device_ops": 1, "qmm_gemv_ms": 0.0,
               "decode_attention_ms": 0.0, "lsq_fakequant_ms": 0.0,
               "lsq_fakequant_bwd_ms": 0.0, "top": []})[1])
    return chip_smoke


def _short_prompts(cfg, rng):
    """Phase 4's 8 prompts at a sixteenth of their lengths (8-32 tokens,
    padded to 32)."""
    lengths = np.linspace(8, 32, 8).astype(np.int32)
    tokens = np.zeros((8, 32), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, cfg.vocab, n)
    return tokens, lengths


def test_chip_smoke_joint_runs_on_cpu(cpu_card, monkeypatch):
    """chip_smoke.py's joint phase at smoke size on the CPU (prompts cut
    to 8-32 tokens), the kernels stood in for by their plain versions:
    J1-J5 hold, with one int8 and one int4 layer and the 4/2 weights of a
    joint take; the kernel path and the plain path are one code path
    here, so J5 reads 0."""
    monkeypatch.setattr(cpu_card, "JOINT_DECODE", 3)
    monkeypatch.setattr(cpu_card, "make_prompts", _short_prompts)
    cfg = olmo_1b.config().smoke()
    policy = ttf.build_policy(cfg)
    take = tk.select_for_budget(policy, tk.synthetic_gains(policy),
                                0.7).take
    take.update({"pat0.cache.L0": True, "pat0.cache.L1": False})
    raw = ttf.init_params(cfg, seed=0, device="cpu")
    rec = cpu_card.phase_joint(cfg, torch.device("cpu"), raw, take,
                               "cpu rehearsal")
    assert rec["cache_bits"] == [[8], [4]]
    assert rec["tokens_equal"] and rec["j4_equal"]
    assert rec["j4_projections"] == 7 * cfg.n_repeats
    for key in ("kernel_vs_plain", "fake_quant_vs_plain",
                "fake_quant_vs_packed", "layout_control"):
        assert max(rec["j5"][key]) == 0.0, key
    assert len(rec["j5"]["control"]) == 4
    for layout in LAYOUTS:
        kv = rec["kv_bytes"][layout]
        assert kv["int4"] < kv["mixed"] == kv["sum_of_layers"] < kv["int8"]
    runs = rec["runs"]
    assert runs["fake_quant-contiguous"]["launches"]["quant_matmul"] == 0
    assert runs["packed-paged"]["launches"]["kv_decode_attention"] == 0
    assert runs["packed-paged"]["launches"][
        "paged_kv_decode_attention"] == 63 * cfg.n_repeats
    assert runs["fake_quant-contiguous"]["tokens"] == \
        runs["packed-contiguous"]["tokens"]
