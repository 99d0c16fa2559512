"""The port's serving path against the JAX package on the CPU: the JAX
raw param tree loads through ``from_jax_params``, packs byte-equal to the
reference, prefills to the same logits and decodes the same greedy tokens.

The greedy ladder mirrors tests/test_serve.py (its prompts: seed 16 for
uniform int4, 17 for the mixed policy, 20 for the quantized caches), over
contiguous and paged caches.  Token equality between two numerics stacks
rests on ulp-level agreement: XLA's fused jit contracts multiply-adds and
orders its reductions unlike PyTorch, and on exact rounding ties (frequent
in the int4 KV quantizer, whose inputs are sums of small integer products)
that decides a code.  Free-running, the int4 cache diverges on most
prompts (ROADMAP Queue 3; ``python tests/test_torch_serve.py`` reprints
that table); ``test_int4_cache_step_isolation`` shows, step by step, that
every difference is such a tie.
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
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.models.layout import LayerBuckets  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.convert import from_jax_cache, from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.quant import PackedLinear  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import EngineSpec, ServeEngine, pack_params  # noqa: E402

MAX_SEQ = 64
CACHES = [("full", 8), ("quantized", 8), ("quantized", 4)]
PROMPT_SEED = {("uniform", "full"): 16, ("mixed", "full"): 17}


def _make_setup():
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
            "arrays": arrays, "jengines": {}}


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _prompt(policy, cache):
    seed = PROMPT_SEED.get((policy, cache), 20)
    rows = 2 if seed == 16 else 1
    return np.random.default_rng(seed).integers(0, 512, (rows, 12)).astype(
        np.int32)


def _jax_engine(setup, policy, cache, bits, layout="contiguous"):
    key = (policy, cache, bits, layout)
    if key not in setup["jengines"]:
        ja = setup["arrays"][policy][0]
        setup["jengines"][key] = JEngine(
            cfg=setup["jcfg"], params=jpack(setup["jparams"], ja,
                                            setup["jcfg"]),
            policy_arrays=jax.tree.map(jnp.asarray, ja), ctx=local_context(),
            max_seq=MAX_SEQ, spec=JSpec(weights="packed", cache=cache,
                                        cache_bits=bits,
                                        cache_layout=layout))
    return setup["jengines"][key]


def _port_engine(setup, policy, cache, bits, layout="contiguous"):
    ta = setup["arrays"][policy][1]
    params = pack_params(setup["tparams"], ta, setup["cfg"], device="cpu")
    return ServeEngine(setup["cfg"], params, ta, MAX_SEQ,
                       EngineSpec(cache=cache, cache_bits=bits,
                                  cache_layout=layout),
                       device="cpu")


def _compare_packed(j, t, path=""):
    if isinstance(t, PackedLinear):
        assert (t.bits, t.k_dim) == (j.bits, j.k_dim), path
        np.testing.assert_array_equal(t.wp.numpy(), np.asarray(j.wp), path)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale),
                                      path)
        np.testing.assert_array_equal(t.sa.numpy(), np.asarray(j.sa), path)
        return 1
    if isinstance(t, dict):
        assert set(t) == set(j), path
        return sum(_compare_packed(j[k], t[k], f"{path}/{k}") for k in t)
    if isinstance(t, list):
        assert len(t) == len(j), path
        return sum(_compare_packed(a, b, f"{path}[{i}]")
                   for i, (a, b) in enumerate(zip(j, t)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), path)
    return 1


def test_from_jax_params_layout(setup):
    tp, jp = setup["tparams"], setup["jparams"]
    assert len(tp["pat"]) == setup["cfg"].n_repeats
    for r, layer in enumerate(tp["pat"]):
        w = layer["p0"]["mlp"]["down"]["w"]
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(jp["pat"]["p0"]["mlp"]["down"]["w"])[r])
    np.testing.assert_array_equal(tp["embed"]["w"].numpy(),
                                  np.asarray(jp["embed"]["w"]))


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_pack_params_byte_equal(setup, policy):
    ja, ta = setup["arrays"][policy]
    want = jpack(setup["jparams"], ja, setup["jcfg"], layout="unrolled")
    got = pack_params(setup["tparams"], ta, setup["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    bits = {p.bits for layer in got["pat"] for blk in layer.values()
            for grp in (blk["attn"], blk["mlp"]) for p in grp.values()}
    assert bits == ({4} if policy == "uniform" else {2, 4})


def test_weight_bytes(setup):
    """bf16 bytes count every packed projection and the int8 embedding at
    2 bytes per weight; the packed tree is smaller by the bit-widths."""
    from repro_torch.serve import packing
    cfg = setup["cfg"]
    ta = setup["arrays"]["mixed"][1]
    got = pack_params(setup["tparams"], ta, cfg, device="cpu")
    n_proj = (cfg.d_model * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
              + cfg.n_heads * cfg.head_dim * cfg.d_model
              + 3 * cfg.d_model * cfg.d_ff)
    want = 2 * (cfg.vocab * cfg.d_model + cfg.n_repeats * n_proj)
    assert packing.bf16_weight_bytes(got) == want
    assert packing.resident_weight_bytes(got) < want // 2


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_prefill_logits_match(setup, policy):
    """Prefill logits within 1e-4 * max|logit| of the JAX packed engine
    (float32; the engines differ in summation order only)."""
    prompt = np.random.default_rng(7).integers(0, 512, (2, 12)).astype(
        np.int32)
    lengths = np.array([12, 7], np.int32)
    je = _jax_engine(setup, policy, "full", 8)
    want, jpre = je.prefill(jnp.asarray(prompt), jnp.asarray(lengths))
    te = _port_engine(setup, policy, "full", 8)
    got, tpre = te.prefill(torch.as_tensor(prompt), torch.as_tensor(lengths))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    jk_ = np.asarray(jax.tree.leaves(jpre)[0])   # first layer's K (bucketed)
    tk_ = tpre["pat"][0]["p0"]["k"].numpy()
    assert np.abs(tk_ - jk_[0]).max() <= 1e-4 * np.abs(jk_).max()


@pytest.mark.parametrize("cache,bits", CACHES[:2])
@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_greedy_ladder_matches_jax(setup, policy, cache, bits):
    """16 greedy tokens equal to the JAX packed engine's (full and int8
    caches)."""
    prompt = _prompt(policy, cache)
    want = np.asarray(_jax_engine(setup, policy, cache, bits).generate(
        jnp.asarray(prompt), n_new=16))
    got = _port_engine(setup, policy, cache, bits).generate(prompt, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache,bits", CACHES[:2])
@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_paged_ladder_matches_jax(setup, policy, cache, bits):
    """Paged generate: 16 greedy tokens equal to the JAX packed engine's
    paged generate (full and int8 caches)."""
    prompt = _prompt(policy, cache)
    want = np.asarray(_jax_engine(setup, policy, cache, bits, "paged")
                      .generate(jnp.asarray(prompt), n_new=16))
    got = _port_engine(setup, policy, cache, bits, "paged").generate(prompt,
                                                                    16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache,bits", CACHES)
def test_paged_generate_equals_contiguous(setup, cache, bits):
    """Paged and contiguous generate give the same tokens, batched with
    unequal prompts (page 16 over max_seq 64)."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, (3, 20)).astype(np.int32)
    lengths = [20, 5, 17]
    want = _port_engine(setup, "mixed", cache, bits).generate(
        toks, 24, lengths=lengths)
    got = _port_engine(setup, "mixed", cache, bits, "paged").generate(
        toks, 24, lengths=lengths)
    assert torch.equal(got, want)


def test_engine_fake_quant_calls_per_step(setup, monkeypatch):
    """A prefill and a decode step each fake-quantize 4 inputs a layer
    (q/k/v grouped, o, gate/up grouped, down) and the head's: 4 L + 1
    calls of ``ops.lsq_fakequant``, one launch each on the card."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.lsq_fakequant

    def counted(x, step, bits, impl="auto"):
        calls.append(len(step) if isinstance(step, (list, tuple)) else 1)
        return real(x, step, bits, impl=impl)

    monkeypatch.setattr(ops, "lsq_fakequant", counted)
    engine = _port_engine(setup, "mixed", "quantized", 8)
    prompt = torch.as_tensor(_prompt("mixed", "quantized"))
    last, pre = engine.prefill(prompt, torch.tensor([prompt.shape[1]]))
    n_layers = setup["cfg"].n_repeats
    want = [3, 1, 2, 1] * n_layers + [1]
    assert calls == want
    calls.clear()
    cache = engine.splice_prefill(pre, torch.tensor([prompt.shape[1]]))
    engine.decode_step(cache, last.argmax(-1, keepdim=True))
    assert calls == want


def test_paged_engine_refuses_small_pools(setup):
    ta = setup["arrays"]["mixed"][1]
    params = pack_params(setup["tparams"], ta, setup["cfg"], device="cpu")
    engine = ServeEngine(setup["cfg"], params, ta, MAX_SEQ,
                         EngineSpec(cache_layout="paged", n_pages=2),
                         device="cpu")
    with pytest.raises(ValueError, match="cannot back a 3-slot"):
        engine.new_cache(3)
    with pytest.raises(ValueError, match="max_pages"):
        engine.generate(np.zeros((2, 4), np.int32), 2)


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_int4_cache_ladder(setup, policy):
    """The int4-cache rows of the ladder.  Token equality with JAX is a
    recorded miss (ROADMAP Queue 3): the int4 quantizer meets exact
    rounding ties that ulp-level differences decide.  What holds: the
    spliced int4 cache dequantizes to within one code step of the
    reference's, the first token (cache-free prefill) is JAX's, and the
    engine equals the port's own stepwise decode over the same cache."""
    from repro.serve import kv_cache as jkv
    from repro_torch.serve import kv_cache as tkv
    prompt = _prompt(policy, "quantized")
    je = _jax_engine(setup, policy, "quantized", 4)
    te = _port_engine(setup, policy, "quantized", 4)
    lengths = np.array([prompt.shape[1]], np.int32)
    jlast, jpre = je.prefill(jnp.asarray(prompt))
    tlast, tpre = te.prefill(torch.as_tensor(prompt))
    jc = jkv.splice_prefill(je.new_cache(1), jpre, jnp.asarray(lengths))
    tc = tkv.splice_prefill(te.new_cache(1), tpre, torch.as_tensor(lengths))
    jleaves = jax.tree.leaves(jc.layers)       # bucketed: (1, ...) stacks
    for r in range(setup["cfg"].n_repeats):
        got = tc.layers["pat"][r]["p0"]
        want = {k: np.concatenate([np.asarray(a) for a in jleaves[i::4]])[r]
                for i, k in enumerate(sorted(got))}
        for kind in ("k", "v"):
            deq = getattr(tkv.kvq, f"dequant_{kind}")
            a = deq(got[f"{kind}q"], got[f"{kind}_scale"], 4).numpy()
            b = deq(torch.as_tensor(want[f"{kind}q"]),
                    torch.as_tensor(want[f"{kind}_scale"]), 4).numpy()
            step = np.abs(want[f"{kind}_scale"]).max()
            assert np.abs(a - b).max() <= 1.001 * step, (r, kind)
    assert int(np.argmax(np.asarray(jlast)[0])) == int(tlast[0].argmax())
    tokens = te.generate(prompt, 16)[0]
    tok = tokens[:1][None]
    for i in range(1, 16):
        tc, logits = te.decode_step(tc, tok)
        tok = logits.argmax(-1, keepdim=True)
        assert int(tok) == int(tokens[i]), i


@pytest.mark.parametrize("cache,bits", [("full", 8), ("quantized", 4)])
def test_batched_unequal_prompts_equal_solo(setup, cache, bits):
    engine = _port_engine(setup, "mixed", cache, bits)
    rng = np.random.default_rng(6)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :10] = rng.integers(0, 512, 10)
    toks[1, :16] = rng.integers(0, 512, 16)
    out = engine.generate(toks, 16, lengths=[10, 16]).numpy()
    solo0 = engine.generate(toks[:1], 16, lengths=[10]).numpy()
    solo1 = engine.generate(toks[1:], 16).numpy()
    np.testing.assert_array_equal(out[0], solo0[0])
    np.testing.assert_array_equal(out[1], solo1[0])


def test_cache_write_drops_inactive_rows():
    """A decode write lands at each request's own position; a position at
    or past S_max (an inactive slot) leaves its row untouched."""
    from repro_torch.models.attention import cache_write
    cache = torch.zeros((3, 4, 2))
    new = torch.arange(1, 7, dtype=torch.float32).reshape(3, 1, 2)
    cache_write(cache, new, torch.tensor([[0], [3], [4]]))
    want = torch.zeros((3, 4, 2))
    want[0, 0] = new[0, 0]
    want[1, 3] = new[1, 0]
    assert torch.equal(cache, want)


def test_unported_options_raise(setup):
    from repro_torch.serve.sampling import SamplerConfig
    EngineSpec(cache_layout="paged").validate()
    for kw in ({"cache_layout": "blocked"},
               {"cache_layout": "paged", "page_size": 0},
               {"cache_layout": "paged", "n_pages": 0}):
        with pytest.raises(ValueError):
            EngineSpec(**kw).validate()
    with pytest.raises(ValueError, match="causal"):
        EngineSpec(cache_layout="paged").validate(
            setup["cfg"].replace(causal=False))
    with pytest.raises(NotImplementedError, match="item 11"):
        EngineSpec(sampler=SamplerConfig("top_k", top_k=4)).validate()
    with pytest.raises(NotImplementedError, match="item 5"):
        EngineSpec(weights="fake_quant").validate()
    for kw in ({"mesh": object()}, {"draft": object()},
               {"prefill_chunk": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EngineSpec(**kw).validate()
    ta = setup["arrays"]["uniform"][1]
    with pytest.raises(ValueError, match="packed"):
        ServeEngine(setup["cfg"], setup["tparams"], ta, MAX_SEQ,
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pack_params(setup["tparams"], ta, setup["cfg"])


def test_chip_smoke_check_runs_on_cpu(setup):
    """chip_smoke.py's end-to-end check at smoke size on the CPU, where the
    kernel path and the plain path are one code path: every reading covers
    the prefill and each decode step (of every block), the kernel path's
    read 0, and the control (float64 prefill attention) stays finite."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg, ta = setup["cfg"], setup["arrays"]["mixed"][1]
    packed = pack_params(setup["tparams"], ta, cfg, device="cpu")
    lengths = np.array([5, 9, 12], np.int32)
    tokens = np.random.default_rng(8).integers(0, 512, (3, 12))
    res = chip_smoke.phase_check(cfg, packed, ta, torch.device("cpu"),
                                 tokens, lengths, n_decode=3)
    for bits in (8, 4):
        r = res[bits]
        for key in ("rel_logit_err", "control_rel_logit_err",
                    "one_block_rel_logit_err"):
            assert len(r[key]) == 4
        assert [len(row) for row in r["block_rel_rms_err"]] == \
            [cfg.n_repeats] * 4
        assert max(r["rel_logit_err"]) == 0.0
        assert max(r["one_block_rel_logit_err"]) == 0.0
        assert max(max(row) for row in r["block_rel_rms_err"]) == 0.0
        assert np.isfinite(r["control_rel_logit_err"]).all()


TIE_TAU = 1e-5      # code steps: how close to a rounding boundary a tie is
VS_REL = 1e-6       # a decode row's V scale, port against JAX, relative


def _jax_state(cache):
    """A JAX serving cache as numpy: (layers with "pat" stacked on the
    layer axis, lengths, block table or None)."""
    pat = cache.layers["pat"]
    if isinstance(pat, LayerBuckets):
        pat = jax.tree.map(lambda *xs: np.concatenate(
            [np.asarray(x) for x in xs]), *pat.buckets)
    layers = {"pat": jax.tree.map(np.asarray, pat)}
    tbl = getattr(cache, "block_tbl", None)
    return (layers, np.asarray(cache.lengths),
            None if tbl is None else np.asarray(tbl))


def _codes(a):
    from repro_torch.kernels import kv_quant
    return kv_quant.unpack4(torch.as_tensor(np.asarray(a)),
                            torch.int32).numpy()


def _step_isolation(setup, policy, layout, monkeypatch, seeds=range(1, 11),
                    n_steps=16):
    """Run the JAX packed engine's int4 decode step by step (verify_step +
    commit_verified: one cache row and the logits per step).  Before each
    step, carry its cache into the port (``from_jax_cache``) and let the
    port decode JAX's token on it.  Then, layer by layer:

      (a) every int4 K/V code the port wrote equals JAX's, or the port's
          unrounded x/scale lies within TIE_TAU code steps of a rounding
          boundary and the codes differ by one step.  Everything else in
          the cache equals JAX's after the step; the written V scale is
          within VS_REL of JAX's.  After the first layer with a differing
          code the next layers see another input, so the step is checked
          up to that layer;
      (b) in a step where no code differs, the logits are within
          1e-4 * max|logit| of JAX's (the bound the prefill logits meet).

    TIE_TAU: the port's and XLA's projections round their sums apart by a
    few float32 ulps.  A decode row's V scale (max|v| / 7, about 0.35)
    differs by |dscale| ~ 6e-8 (ROADMAP Queue 3), which moves x/scale by at
    most 7.5 * 6e-8 / 0.35 ~ 1.3e-6 code steps; each ulp of |v| <= 2.6
    moves it by ~7e-7 more.  Measured on the contiguous runs of this test
    (the paged runs flip the same codes): every tie is a V code, at most
    2.9e-6 code steps from its boundary (at |x/scale| = 6.5), so
    TIE_TAU = 1e-5 leaves a 3.4x margin; 2e-6 fails.  A real fault moves codes by whole steps: a swapped nibble
    order, a V scale written one row late, or a V scale off by a relative
    1e-5 each fail this test.
    Returns (ties, steps, steps with a tie)."""
    from repro_torch.kernels import kv_quant
    je = _jax_engine(setup, policy, "quantized", 4, layout)
    te = _port_engine(setup, policy, "quantized", 4, layout)
    seen = []
    encode = kv_quant._encode

    def recording(x, scale, bits):
        seen.append((x.float() / scale).numpy())
        return encode(x, scale, bits)

    monkeypatch.setattr(kv_quant, "_encode", recording)
    paged = layout == "paged"
    splice = jpaging.splice_prefill if paged else jkv.splice_prefill
    ties = steps = tied_steps = 0
    for seed in seeds:
        prompt = np.random.default_rng(seed).integers(0, 512, (1, 12))
        jlast, jpre = je.prefill(jnp.asarray(prompt, jnp.int32))
        jc = splice(je.new_cache(1), jpre, jnp.asarray([12], jnp.int32))
        tok = int(np.argmax(np.asarray(jlast)[0]))
        for t in range(n_steps):
            layers, lengths, tbl = _jax_state(jc)
            pos = int(lengths[0])
            seen.clear()
            tc, tlogits = te.decode_step(
                from_jax_cache(layers, lengths, tbl, device="cpu"),
                torch.tensor([[tok]]))
            jl, greedy, jlogits = je.verify_step(jc, jnp.asarray([[tok]]))
            jc = je.commit_verified(jc, jl, jnp.ones((1,), jnp.int32))
            after, _, _ = _jax_state(jc)
            row = ((int(tbl[0, pos // 16]), pos % 16) if paged else (0, pos))
            flipped = False
            for r, tleaf in enumerate(tc.layers["pat"]):
                tleaf, jleaf = tleaf["p0"], after["pat"]["p0"]
                names = (("pkq", "pvq", "pv_scale") if paged
                         else ("kq", "vq", "v_scale"))
                for i, name in enumerate(names[:2]):
                    got = _codes(tleaf[name])
                    want = _codes(jleaf[name][r])
                    diff = got != want
                    outside = diff.copy()
                    outside[row] = False
                    assert not outside.any(), (seed, t, r, name)
                    if diff[row].any():
                        u = seen[2 * r + i][0, 0]
                        near = np.abs(np.abs(u) % 1.0 - 0.5) <= TIE_TAU
                        step = np.abs(got[row] - want[row])
                        assert (near & (step == 1))[diff[row]].all(), \
                            (seed, t, r, name, u[diff[row]])
                        ties += int(diff[row].sum())
                        flipped = True
                vs_t = tleaf[names[2]].numpy()
                vs_j = np.asarray(jleaf[names[2]][r])
                np.testing.assert_array_equal(np.delete(vs_t.reshape(
                    -1, vs_t.shape[-1]), np.ravel_multi_index(
                        row, vs_t.shape[:2]), 0), np.delete(vs_j.reshape(
                            -1, vs_j.shape[-1]), np.ravel_multi_index(
                                row, vs_j.shape[:2]), 0))
                np.testing.assert_allclose(vs_t[row], vs_j[row], rtol=VS_REL,
                                           atol=0)
                np.testing.assert_array_equal(tleaf["k_scale"].numpy(),
                                              np.asarray(jleaf["k_scale"][r]))
                if flipped:
                    break
            steps += 1
            tied_steps += flipped
            if not flipped:
                want = np.asarray(jlogits)[:, 0]
                assert np.abs(tlogits.numpy() - want).max() \
                    <= 1e-4 * np.abs(want).max(), (seed, t)
            tok = int(np.asarray(greedy)[0, 0])
    return ties, steps, tied_steps


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_int4_cache_step_isolation(setup, policy, layout, monkeypatch,
                                   capsys):
    """The int4-cache misses against JAX are rounding ties only: on the
    prompts of ROADMAP Queue 3 (seeds 1-10, 16 steps), every code the port
    writes is JAX's or a tie, and every step without a tie gives JAX's
    logits (``_step_isolation``)."""
    ties, steps, tied = _step_isolation(setup, policy, layout, monkeypatch)
    with capsys.disabled():
        print(f"\n[int4 isolation {policy}/{layout}] {ties} tied codes in "
              f"{tied} of {steps} steps")
    assert steps == 160


def test_chip_smoke_select_runs_on_cpu(setup):
    """chip_smoke.py's select phase at smoke size on the CPU: EAGL through
    the default dispatch and through impl="ref" agree exactly, the take is
    JAX's EAGL take at budget 0.7, and it mixes 4 and 2 bits."""
    import sys
    from pathlib import Path
    from repro.core.metrics import eagl as jeagl
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    mixed, rec = chip_smoke.phase_select(setup["cfg"], setup["tparams"],
                                         torch.device("cpu"))
    jpol = jtf.build_policy(setup["jcfg"])
    jgains = jeagl.eagl_gains(jpol, lambda u, t: jtf.fetch_unit_tensor(
        setup["jparams"], u, t), impl="ref")
    jtake = jk.select_for_budget(jpol, jgains, 0.7).take
    assert rec["gains_max_rel_diff"] == 0.0 and rec["take_equal"]
    assert rec["tensors"] == 7 * setup["cfg"].n_repeats
    assert {n: b == 4.0 for n, b in rec["mix"].items()} == jtake
    assert rec["n4"] and rec["n2"]
    assert mixed.bits_of(next(iter(rec["mix"]))) in (2.0, 4.0)


def divergence_table(seeds=range(1, 11)):
    """(policy, cache, bits, seed, first differing step or None, the
    port's logit margin for its token over JAX's there) for (1, 12)
    prompts; reproduces the ROADMAP Queue 3 entry."""
    from repro_torch.serve import kv_cache
    st = _make_setup()
    rows = []
    for policy in ("uniform", "mixed"):
        for cache, bits in CACHES:
            te = _port_engine(st, policy, cache, bits)
            for seed in seeds:
                prompt = np.random.default_rng(seed).integers(
                    0, 512, (1, 12)).astype(np.int32)
                want = np.asarray(_jax_engine(st, policy, cache, bits)
                                  .generate(jnp.asarray(prompt), n_new=16))[0]
                got = te.generate(prompt, 16).numpy()[0]
                diff = np.flatnonzero(got != want)
                if not diff.size:
                    rows.append((policy, cache, bits, seed, None, None))
                    continue
                step = int(diff[0])
                # replay the port on the shared prefix to read its logits
                logit, pre = te.prefill(torch.as_tensor(prompt))
                state = kv_cache.splice_prefill(te.new_cache(1), pre,
                                                torch.tensor([12]))
                for tok in want[:step]:
                    state, logit = te.decode_step(
                        state, torch.tensor([[int(tok)]]))
                logit = logit[0].numpy()
                rows.append((policy, cache, bits, seed, step,
                             float(logit[got[step]] - logit[want[step]])))
    return rows


if __name__ == "__main__":
    for row in divergence_table():
        print(*row)
