"""The port's continuous-batching scheduler and paged prefix sharing against
the JAX package on the CPU (olmo-1b ``.smoke()``, float32, both sides on
packed weights: the JAX raw params load through ``from_jax_params``).

  * the scheduler ladders of tests/test_serve.py, replayed: full and int8
    caches give JAX's completions token for token, contiguous and paged
    (prefix hits, copy-on-write, eviction, re-admission onto recycled
    pages), and ``latency_report`` equals JAX's dict.  Int4 caches: the
    port's scheduler equals the port's solo run exactly, as JAX's equals
    JAX's (tests/test_serve.py), so any port-JAX difference is the
    engines' own, which ROADMAP Queue 3 item 1 shows to be rounding ties
    (``test_torch_serve.test_int4_cache_step_isolation``);
  * host bookkeeping: seeded interleavings of ``PageAllocator``,
    ``PrefixRegistry`` and ``plan_admission`` leave the same pages,
    refcounts, hits and misses as JAX's;
  * device page ops (``write_slot_pages``, ``copy_pages``, get/set K
    scales): exact against JAX on the same numpy inputs;
  * the suffix prefill: last logits and rows within 1e-4 * max of JAX's
    (the bound the whole-prompt prefill logits meet);
  * refusals of what is not ported name their ROADMAP items.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layout import LayerBuckets  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import EngineSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import paging as jpaging  # noqa: E402
from repro.serve.scheduler import \
    ContinuousBatchingScheduler as JScheduler  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,  # noqa: E402
                               EngineSpec, Request, SamplerConfig,
                               ServeEngine, pack_params, paging, serve_all)

PAGED_MODES = [("full", 8), ("quantized", 8), ("quantized", 4)]
REL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = configs.get_config("olmo-1b").smoke()
    cfg = olmo_1b.config().smoke()
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ja, ta = jtf.build_policy(jcfg).as_arrays(), ttf.build_policy(cfg)
    ta = ta.as_arrays()
    return {"jcfg": jcfg, "cfg": cfg,
            "jpacked": jpack(jparams, ja, jcfg),
            "ja": jax.tree.map(jnp.asarray, ja), "ta": ta,
            "tpacked": pack_params(tparams, ta, cfg, device="cpu"),
            "jengines": {}}


def _engines(setup, cache="full", bits=8, layout="contiguous", max_seq=64,
             **kw):
    """(JAX engine, port engine) of one spec; JAX's are cached (its jit
    caches are what cost time here)."""
    key = (cache, bits, layout, max_seq, tuple(sorted(kw.items())))
    if key not in setup["jengines"]:
        setup["jengines"][key] = JEngine(
            cfg=setup["jcfg"], params=setup["jpacked"],
            policy_arrays=setup["ja"], ctx=local_context(), max_seq=max_seq,
            spec=JSpec(weights="packed", cache=cache, cache_bits=bits,
                       cache_layout=layout, **kw))
    te = ServeEngine(setup["cfg"], setup["tpacked"], setup["ta"], max_seq,
                     EngineSpec(cache=cache, cache_bits=bits,
                                cache_layout=layout, **kw), device="cpu")
    return setup["jengines"][key], te


def _serve_both(je, te, reqs, n_slots, **kw):
    """Serve ``reqs`` ((uid, prompt, max_new, eos) tuples) through JAX's
    scheduler and the port's; returns both schedulers, drained."""
    js = JScheduler(je, n_slots=n_slots, **kw)
    ts = ContinuousBatchingScheduler(te, n_slots=n_slots, **kw)
    for uid, prompt, n, eos in reqs:
        js.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n,
                           eos_id=eos))
        ts.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n,
                          eos_id=eos))
    js.run()
    ts.run()
    return js, ts


def _assert_same(js, ts):
    assert set(ts.completed) == set(js.completed)
    for uid, want in js.completed.items():
        got = ts.completed[uid]
        assert got.tokens == [int(t) for t in want.tokens], uid
        assert (got.finish_reason, got.prompt_len) == \
            (want.finish_reason, want.prompt_len), uid
    assert ts.latency_report() == js.latency_report()


def _prompts(rng, lengths, vocab=512):
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


# ---------------------------------------------------- scheduler ladders
def test_scheduler_continuous_batching_parity(setup):
    """3 requests with unequal prompts through 2 slots (tests/test_serve.py
    ``test_scheduler_continuous_batching_parity``): JAX's tokens, finish
    reasons and latency report."""
    je, te = _engines(setup)
    prompts = _prompts(np.random.default_rng(7), (12, 16, 7))
    js, ts = _serve_both(je, te, [(f"r{i}", p, 16, None)
                                  for i, p in enumerate(prompts)], 2)
    _assert_same(js, ts)
    assert all(c.finish_reason == "length" for c in ts.completed.values())


def test_scheduler_eos_eviction_and_reuse(setup):
    """EOS stops a request early, frees its slot, and the queue refills it
    (``test_scheduler_eos_eviction_and_reuse``)."""
    je, te = _engines(setup)
    prompt = _prompts(np.random.default_rng(8), (12,))[0]
    probe = serve_all(te, [Request(uid="probe", prompt=prompt,
                                   max_new_tokens=12)], n_slots=1)
    eos = probe["probe"].tokens[4]
    js, ts = _serve_both(je, te, [("a", prompt, 12, eos),
                                  ("b", prompt, 8, None)], 1)
    _assert_same(js, ts)
    assert ts.completed["a"].finish_reason == "eos"
    assert ts.completed["a"].tokens == probe["probe"].tokens[:5]
    assert ts.completed["b"].tokens == probe["probe"].tokens[:8]


def test_scheduler_prompt_bucket_never_exceeds_max_seq(setup):
    """A near-max_seq prompt is not bucket-padded past the slot buffers
    (``test_scheduler_prompt_bucket_never_exceeds_max_seq``)."""
    je, te = _engines(setup, max_seq=52)
    prompt = _prompts(np.random.default_rng(11), (50,))[0]
    js, ts = _serve_both(je, te, [("tight", prompt, 2, None)], 1)
    _assert_same(js, ts)
    assert len(ts.completed["tight"].tokens) == 2


def test_quantized_cache_scheduler_admit_evict_readmit(setup):
    """Int8 cache: a shorter prompt re-admitted over the evicted slot's
    stale codes gets a fresh K grid; then unequal slots share a batch
    (``test_quantized_cache_scheduler_admit_evict_readmit``)."""
    je, te = _engines(setup, "quantized", 8)
    rng = np.random.default_rng(22)
    long_p, short_p = _prompts(rng, (15, 7))
    js, ts = _serve_both(je, te, [("a", long_p, 6, None),
                                  ("b", short_p, 8, None)], 1)
    _assert_same(js, ts)
    js, ts = _serve_both(je, te, [(f"r{i}", p, 8, None) for i, p in
                                  enumerate(_prompts(rng, (12, 9, 16)))], 2)
    _assert_same(js, ts)


@pytest.fixture(scope="module")
def paged_prompts():
    rng = np.random.default_rng(31)
    sys_prompt = rng.integers(0, 512, 16).tolist()     # one full page
    return {"a": sys_prompt + rng.integers(0, 512, 5).tolist(),
            "b": sys_prompt + rng.integers(0, 512, 9).tolist(),
            "c": rng.integers(0, 512, 7).tolist()}


@pytest.mark.parametrize("cache,bits", PAGED_MODES)
def test_paged_scheduler_differential_ladder(setup, paged_prompts, cache,
                                             bits):
    """``test_paged_scheduler_differential_ladder``: prefix-hit admission
    (full: page-aligned prefix + suffix prefill; quantized: identical
    prompt + copy-on-write of the partial tail page), eviction and
    re-admission onto recycled pages; paged equals contiguous equals solo
    in the port, and JAX's tokens for full and int8 caches."""
    p = paged_prompts
    order = [p["a"], p["b"], p["c"], p["a"]]
    reqs = [(f"r{i}", pr, 6, None) for i, pr in enumerate(order)]
    je, te = _engines(setup, cache, bits, "paged")
    jc, tc = _engines(setup, cache, bits)
    js, ts = _serve_both(je, te, reqs, 2)
    contiguous = serve_all(tc, [Request(uid=u, prompt=pr, max_new_tokens=n)
                                for u, pr, n, _ in reqs], n_slots=2)
    # full: r1 and r3 share r0's page; quantized: r3 is r0's prompt
    assert ts.registry.hits == js.registry.hits == (2 if cache == "full"
                                                    else 1)
    for i, pr in enumerate(order):
        uid = f"r{i}"
        solo = te.generate(np.asarray([pr]), 6)[0].tolist()
        assert ts.completed[uid].tokens == solo, uid
        assert contiguous[uid].tokens == solo, uid
    if bits == 8:
        _assert_same(js, ts)
    else:
        # JAX's scheduler equals JAX's solo run on this ladder (its own
        # tests/test_serve.py::test_paged_scheduler_differential_ladder)
        assert ts.latency_report() == js.latency_report()


def test_paged_prefix_sharing_actually_shares(setup, paged_prompts):
    """``test_paged_prefix_sharing_actually_shares``: admissions after the
    first share pages (hits and misses as JAX counts them, the registry
    keeps its pages past the evictions), and without sharing every page
    returns to the pool; sharing never changes a token."""
    p = paged_prompts
    reqs = [(f"r{i}", pr, 4, None) for i, pr in
            enumerate([p["a"], p["b"], p["a"]])]
    je, te = _engines(setup, "full", 8, "paged")
    js, ts = _serve_both(je, te, reqs, 1)
    _assert_same(js, ts)
    assert (ts.registry.hits, ts.registry.misses) == \
        (js.registry.hits, js.registry.misses)
    assert ts.registry.hits >= 2 and ts.registry.misses >= 1
    assert ts.allocator.in_use == js.allocator.in_use >= 1
    np.testing.assert_array_equal(ts.allocator.refcount,
                                  js.allocator.refcount)
    off = ContinuousBatchingScheduler(te, n_slots=1, share_prefixes=False)
    for uid, pr, n, _ in reqs:
        off.submit(Request(uid=uid, prompt=pr, max_new_tokens=n))
    off.run()
    assert off.allocator.in_use == 0
    for uid, _, _, _ in reqs:
        assert off.completed[uid].tokens == ts.completed[uid].tokens


def test_paged_idle_lanes_and_pool_pressure(setup, paged_prompts):
    """Idle lanes beside a lone request with max_seq % page != 0 (their
    pinned position lies inside the table), then a tight pool (6 pages)
    that defers admissions and recycles pages: JAX's tokens, allocator
    state and latency report."""
    p = paged_prompts
    je, te = _engines(setup, "quantized", 8, "paged", max_seq=60)
    js, ts = _serve_both(je, te, [("lone", p["a"], 8, None)], 4)
    _assert_same(js, ts)
    je, te = _engines(setup, "quantized", 8, "paged", n_pages=6,
                      decode_chunk=4)
    js, ts = _serve_both(je, te, [("t0", p["a"], 10, None),
                                  ("t1", p["c"], 3, None),
                                  ("t2", p["a"], 8, None)], 2)
    _assert_same(js, ts)
    np.testing.assert_array_equal(ts.allocator.refcount,
                                  js.allocator.refcount)
    assert ts.allocator.peak_in_use == js.allocator.peak_in_use


# ---------------------------------------------------- host bookkeeping
PAGE = 4


def _trace(pg, n_pages, ops, share):
    """The allocator / registry / planner trace of tests/test_paging.py
    (admit, evict, drop an entry), run through module ``pg``; returns the
    state after every op."""
    alloc = pg.PageAllocator(n_pages, PAGE)
    registry = pg.PrefixRegistry(alloc, capacity=4) if share else None
    slot_maps, states, next_slot = {}, [], 0
    rng = np.random.default_rng(0)
    prompts = [tuple(rng.integers(0, 50, n).tolist())
               for n in (3, PAGE, PAGE + 2, 2 * PAGE, 2 * PAGE + 1)]
    for op, arg in ops:
        plan = None
        if op == "admit":
            prompt = prompts[arg % len(prompts)]
            quantized = bool(arg % 2)
            plan = pg.plan_admission(alloc, registry, prompt, 1 + arg % 5,
                                     quantized=quantized)
            if plan is not None:
                slot_maps[next_slot] = plan.pages
                next_slot += 1
                if registry is not None and plan.entry is None:
                    n = (len(prompt) if quantized
                         else (len(prompt) // PAGE) * PAGE)
                    if n >= PAGE or quantized:
                        registry.register(pg.PrefixEntry(
                            key=prompt[:n],
                            pages=plan.pages[:-(-n // PAGE)], n_tokens=n,
                            full_prompt=quantized))
        elif op == "evict" and slot_maps:
            keys = sorted(slot_maps)
            alloc.release(slot_maps.pop(keys[arg % len(keys)]))
        elif op == "drop_entry" and registry is not None and registry.entries:
            keys = sorted(registry.entries)
            registry.drop(keys[arg % len(keys)])
        alloc.check()
        states.append((
            None if plan is None else (plan.shared, plan.fresh, plan.cow_src,
                                       plan.suffix_start,
                                       None if plan.entry is None
                                       else plan.entry.key),
            alloc.refcount.tolist(), list(alloc._free), alloc.peak_in_use,
            None if registry is None else (registry.hits, registry.misses,
                                           sorted(registry.entries))))
    return states


@pytest.mark.parametrize("seed", range(8))
def test_host_bookkeeping_matches_jax(seed):
    """Seeded interleavings (tests/test_paging.py's runner): every plan,
    refcount, free list, peak, hit and miss equals JAX's after every op."""
    rng = np.random.default_rng(seed)
    ops = [(["admit", "admit", "evict", "drop_entry"][rng.integers(4)],
            int(rng.integers(10**6))) for _ in range(40)]
    n_pages, share = int(rng.integers(4, 13)), bool(seed % 2)
    assert _trace(paging, n_pages, ops, share) == \
        _trace(jpaging, n_pages, ops, share)


def test_registry_and_plan_edge_cases_match_jax():
    """The LRU sweep under pressure, the quantized identical-prompt rule
    (copy-on-write of the partial tail) and the aligned hit that hands its
    last page back for logits, as tests/test_paging.py pins them; the
    port's plans equal JAX's."""
    def run(pg):
        alloc = pg.PageAllocator(16, PAGE)
        reg = pg.PrefixRegistry(alloc, capacity=3)
        out = []
        prefix = (1, 2, 3, 4, 5, 6, 7, 8)
        plan = pg.plan_admission(alloc, reg, prefix + (9,), 3,
                                 quantized=False)
        reg.register(pg.PrefixEntry(key=prefix, pages=plan.pages[:2],
                                    n_tokens=8, full_prompt=False))
        for prompt, q in ((prefix + (7, 7, 7), False), (prefix, False),
                          ((5, 6, 7, 8, 9), True), ((5, 6, 7, 8, 9), True),
                          ((5, 6, 7, 8, 9, 1), True)):
            p = pg.plan_admission(alloc, reg, prompt, 3, quantized=q)
            out.append((p.shared, p.fresh, p.cow_src, p.suffix_start))
            if q and p.entry is None:
                reg.register(pg.PrefixEntry(key=prompt, pages=p.pages[:2],
                                            n_tokens=len(prompt),
                                            full_prompt=True))
        reg.make_room(12)
        return out, alloc.refcount.tolist(), reg.hits, reg.misses, \
            sorted(reg.entries)

    assert run(paging) == run(jpaging)


# ----------------------------------------------------- device page ops
def _jax_pat(cache):
    """A JAX paged cache's pattern leaves, stacked on the layer axis."""
    pat = cache.layers["pat"]
    if isinstance(pat, LayerBuckets):
        pat = jax.tree.map(lambda *xs: np.concatenate(
            [np.asarray(x) for x in xs]), *pat.buckets)
    return jax.tree.map(np.asarray, pat)["p0"]


def _assert_pools_equal(jc, tc):
    jp = _jax_pat(jc)
    for r, layer in enumerate(tc.layers["pat"]):
        for key, t in layer["p0"].items():
            np.testing.assert_array_equal(t.numpy(), jp[key][r],
                                          err_msg=f"layer {r} {key}")


@pytest.mark.parametrize("cache,bits", PAGED_MODES)
def test_page_ops_match_jax(setup, cache, bits):
    """``write_slot_pages`` (a whole prompt from token 0, and for the full
    cache a suffix at a page-aligned start, trimmed to its pages), then
    ``copy_pages`` and get/set K scales: pools and grids exactly JAX's."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    n_layers, hkv, d = cfg.n_repeats, cfg.n_kv_heads, cfg.head_dim
    qbits = None if cache == "full" else bits
    jc = jpaging.init_paged_cache(jcfg, 2, 32, 10, 8, dtype=jnp.float32,
                                  cache_bits=qbits)
    tc = paging.init_paged_cache(cfg, 2, 32, 10, 8, torch.float32, "cpu",
                                 qbits)
    rng = np.random.default_rng(3)

    def write(slot, n_valid, start, pages, s_pad):
        k, v = (rng.normal(size=(n_layers, 1, s_pad, hkv, d))
                .astype(np.float32) for _ in range(2))
        jgot = {"pat": {"p0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}}
        tgot = {"pat": [{"p0": {"k": torch.as_tensor(k[r]),
                                "v": torch.as_tensor(v[r])}}
                        for r in range(n_layers)]}
        return (jpaging.write_slot_pages(jc, jgot, slot, n_valid, start,
                                         pages),
                paging.write_slot_pages(tc, tgot, slot, n_valid, start,
                                        pages))

    jc, tc = write(1, 13, 0, [7, 2], 16)
    _assert_pools_equal(jc, tc)
    if cache == "full":
        jc, tc = write(0, 5, 8, [4], 16)      # rows past one page trimmed
    jc = jpaging.copy_pages(jc, 2, 5)
    tc = paging.copy_pages(tc, 2, 5)
    _assert_pools_equal(jc, tc)
    if cache == "quantized":
        jks = jpaging.get_slot_k_scales(jc, 1)
        tks = paging.get_slot_k_scales(tc, 1)
        assert len(tks) == n_layers
        jc = jpaging.set_slot_k_scales(jc, 0, jks)
        tc = paging.set_slot_k_scales(tc, 0, tks)
        _assert_pools_equal(jc, tc)
        # the snapshot is a copy: a later write to the slot leaves it
        before = [t.clone() for t in tks.values()]
        jc, tc = write(1, 4, 0, [3], 8)
        assert all(torch.equal(a, b) for a, b in zip(before, tks.values()))


def test_set_table_rows_unmaps_the_rest(setup):
    """Eviction's ``set_table_rows(cache, j, [])`` leaves only the -1
    sentinel in row j, as JAX's does."""
    jc = jpaging.init_paged_cache(setup["jcfg"], 2, 32, 10, 8)
    tc = paging.init_paged_cache(setup["cfg"], 2, 32, 10, 8, torch.float32,
                                 "cpu")
    for slot, pages in ((1, [3, 9, 4]), (0, [2]), (1, [])):
        jc = jpaging.set_table_rows(jc, slot, pages)
        tc = paging.set_table_rows(tc, slot, pages)
        np.testing.assert_array_equal(tc.block_tbl.numpy(),
                                      np.asarray(jc.block_tbl))


# ----------------------------------------------------- suffix prefill
def test_prefill_suffix_matches_jax(setup):
    """A prefix of two pages (JAX's own prefill rows, written into pages
    [3, 1] of slot 1 on both sides), then ``prefill_suffix`` of 7 tokens
    padded to 16 at prefix_len 32: last logits and suffix K/V rows within
    1e-4 * max of JAX's; and within the same bound of the port's
    whole-prompt prefill (chunk-order noise only)."""
    je, te = _engines(setup, "full", 8, "paged")
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 512, 39).astype(np.int32)
    pre_tokens = jnp.asarray(prompt[None, :32])
    _, jpre = je.prefill(pre_tokens, jnp.asarray([32], jnp.int32))
    jc = jpaging.set_table_rows(je.new_cache(2), 1, [3, 1, 5, 6])
    jc = jpaging.write_slot_pages(jc, jpre, 1, 32, 0, [3, 1])
    pat = _jax_pat_prefill(jpre)
    tpre = {"pat": [{"p0": {"k": torch.as_tensor(pat["k"][r])[None],
                            "v": torch.as_tensor(pat["v"][r])[None]}}
                    for r in range(setup["cfg"].n_repeats)]}
    tc = paging.set_table_rows(te.new_cache(2), 1, [3, 1, 5, 6])
    tc = paging.write_slot_pages(tc, tpre, 1, 32, 0, [3, 1])
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :7] = prompt[32:]
    jlast, jsuf = je.prefill_suffix(jnp.asarray(suffix), 7, 32, jc, 1)
    tlast, tsuf = te.prefill_suffix(suffix, 7, 32, tc, 1)
    jlast = np.asarray(jlast)
    bound = REL * np.abs(jlast).max()
    assert np.abs(tlast.numpy() - jlast).max() <= bound
    jrows = _jax_pat_prefill(jsuf)
    for r, layer in enumerate(tsuf["pat"]):
        for key in ("k", "v"):
            want = jrows[key][r]
            got = layer["p0"][key][0].numpy()
            assert np.abs(got - want).max() <= REL * np.abs(want).max()
    whole, _ = te.prefill(prompt[None], torch.tensor([39]))
    assert (whole - tlast).abs().max() <= REL * whole.abs().max()


def _jax_pat_prefill(tree):
    pat = tree["pat"]
    if isinstance(pat, LayerBuckets):
        pat = jax.tree.map(lambda *xs: np.concatenate(
            [np.asarray(x) for x in xs]), *pat.buckets)
    return {k: np.asarray(v)[:, 0] for k, v in pat["p0"].items()}


# ----------------------------------------------------------- refusals
def test_unported_scheduling_refuses(setup):
    """Chunked and speculative scheduling (item 10), sampled scheduling
    (item 11) and ``dispatch_audit`` (item 15) raise NotImplementedError
    naming their ROADMAP items; prefill over a quantized or contiguous
    cache is not a suffix prefill."""
    _, te = _engines(setup)
    for kw, item in (({"prefill_chunk": 8}, "item 10"),
                     ({"draft": object()}, "item 10"),
                     ({"sampler": SamplerConfig(kind="temperature")},
                      "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            ServeEngine(setup["cfg"], setup["tpacked"], setup["ta"], 64,
                        EngineSpec(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        ContinuousBatchingScheduler(te, n_slots=1, key=0)
    with pytest.raises(NotImplementedError, match="item 11"):
        serve_all(te, [], n_slots=1, key=0)
    with pytest.raises(NotImplementedError, match="item 15"):
        ContinuousBatchingScheduler(te, n_slots=1).dispatch_audit()
    with pytest.raises(ValueError, match="paged full-dtype"):
        te.prefill_suffix(np.zeros((1, 16)), 3, 16, te.new_cache(1), 0)
    _, tq = _engines(setup, "quantized", 8, "paged")
    with pytest.raises(ValueError, match="paged full-dtype"):
        tq.prefill_suffix(np.zeros((1, 16)), 3, 16, tq.new_cache(1), 0)


# ------------------------------------------- the card workload's geometry
def test_chip_smoke_schedule_workload_pages():
    """chip_smoke.py's schedule workload (24 requests, 8 slots, pools of
    160 pages), served at smoke width on the CPU with olmo-1b's vocabulary
    (the same rng draws, so the same lengths and budgets as on the card):
    the page accounting its gate D asks of the card holds here, since it
    depends only on lengths and budgets: deferrals and at least MIN_HITS
    prefix hits with sharing, a lower peak of pages in use than without,
    every page back without sharing, the allocator's invariants after
    every admission and eviction (the audited scheduler checks them), and
    the first-token logits of every aligned hit within 1e-4 * max of the
    run without sharing (chunk-order noise only)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = olmo_1b.config().smoke().replace(vocab=50304)
    raw = ttf.init_params(cfg, seed=0, device="cpu")
    pa = ttf.build_policy(cfg).as_arrays()
    engine = ServeEngine(cfg, pack_params(raw, pa, cfg, device="cpu"), pa,
                         chip_smoke.SCHED_MAX_SEQ,
                         EngineSpec(cache_layout="paged",
                                    n_pages=chip_smoke.SCHED_POOL),
                         device="cpu")
    reqs = [r + (None,) for r in chip_smoke.schedule_requests(
        cfg, np.random.default_rng(2))]
    dev = torch.device("cpu")
    on, rec = chip_smoke.schedule_run(engine, reqs, dev)
    off, off_rec = chip_smoke.schedule_run(engine, reqs, dev, share=False)
    chip_smoke.check_completions(on, reqs, cfg.vocab)
    assert rec["deferrals"] >= 1
    assert rec["registry_hits"] >= chip_smoke.MIN_HITS
    assert rec["peak_pages"] < off_rec["peak_pages"]
    assert off_rec["pages_in_use_after"] == 0
    hits = [u for u, p in on.plans.items() if p[0] == "aligned"]
    assert len(hits) == rec["registry_hits"]
    for uid in hits:
        want = off.first_logits[uid]
        assert (on.first_logits[uid] - want).abs().max() <= \
            REL * want.abs().max()
