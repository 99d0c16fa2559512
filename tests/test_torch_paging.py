"""The port's paged KV cache against the JAX package on the CPU: the page
read/write primitives, the paged plain attention (against JAX's oracle and
its Pallas kernel in interpret mode), and the cache bookkeeping.

Tolerances: page reads and writes exact; the paged plain attention equals
the port's contiguous plain attention on the gathered cache bit for bit,
is within 1e-5 * max|ref| of JAX's oracle (float32, other summation
orders) and within 1e-5 * max|ref| of the Pallas kernel, whose online
softmax runs page by page."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import kv_quant as jkvq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import kv_quant as tkvq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

REL = 1e-5


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def paged_inputs(bits, lengths, page, n, hkv=2, group=2, d=32, extra=3,
                 seed=0, poison=None):
    """A contiguous quantized cache of ``n * page`` rows per slot and the
    same rows scattered into shuffled pools.  Each slot's table maps the
    pages its length needs; the entries past them are -1 or stale ids of
    other pages.  Unmapped pages hold saturated codes and, with
    ``poison``, NaN V scales.  Returns numpy (q, contiguous cache, pools,
    tbl, positions)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    s = n * page
    k = torch.as_tensor(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    qc = tkvq.quantize_prefill({"k": k, "v": v},
                               torch.tensor(lengths, dtype=torch.int32), bits)
    qc = {key: val.numpy() for key, val in qc.items()}
    p = b * n + extra
    perm = rng.permutation(p)
    dp = qc["kq"].shape[-1]
    fill = 127 if bits == 8 else 0x77
    kq = np.full((p, page, hkv, dp), fill, qc["kq"].dtype)
    vq = np.full((p, page, hkv, dp), fill, qc["vq"].dtype)
    vs = np.full((p, page, hkv), np.nan if poison else 1e3, np.float32)
    tbl = np.full((b, n), -1, np.int32)
    used = 0
    for i, length in enumerate(lengths):
        for j in range(tkvq.page_count(length, page)):
            tbl[i, j] = perm[used]
            rows = slice(j * page, (j + 1) * page)
            kq[perm[used]] = qc["kq"][i, rows]
            vq[perm[used]] = qc["vq"][i, rows]
            vs[perm[used]] = qc["v_scale"][i, rows]
            used += 1
        # stale entries past the slot's pages: ids of other pages, one -1
        tail = np.arange(tkvq.page_count(length, page), n)
        tbl[i, tail] = rng.integers(0, p, tail.size)
        if tail.size:
            tbl[i, tail[-1]] = -1
    q = rng.normal(size=(b, hkv * group, d)).astype(np.float32)
    positions = np.asarray(lengths, np.int32) - 1
    return q, qc, (kq, vq, vs), tbl, positions


GEOMS = [((37, 53), 16, 4), ((1, 64), 16, 4), ((23, 9, 40), 8, 5)]


@pytest.mark.parametrize("lengths,page,n", GEOMS)
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_attention_matches_jax(bits, lengths, page, n):
    """Shuffled table with stale and -1 entries, NaN-poisoned free pages,
    positions mid-page: equal to the contiguous plain attention, close to
    JAX's oracle and to its Pallas kernel."""
    q, qc, (kq, vq, vs), tbl, pos = paged_inputs(bits, lengths, page, n,
                                                 poison=True)
    t = [torch.as_tensor(a) for a in (q, kq, qc["k_scale"], vq, vs, tbl, pos)]
    got = tops.paged_kv_cache_attention(*t, bits).numpy()
    assert np.isfinite(got).all()
    contiguous = tref.kv_cache_attention(
        t[0], *(torch.as_tensor(qc[key]) for key in
                ("kq", "k_scale", "vq", "v_scale")), t[6], bits).numpy()
    np.testing.assert_array_equal(got, contiguous)
    j = [jnp.asarray(a) for a in (q, kq, qc["k_scale"], vq, vs, tbl, pos)]
    for impl in ("ref", "interpret"):
        _close(got, jops.paged_kv_cache_attention(*j, bits, impl=impl))


def test_stale_table_entries_unread():
    """Remapping the entries past a slot's position leaves the output
    unchanged."""
    q, qc, pools, tbl, pos = paged_inputs(8, (17,), 16, 4, hkv=2, group=1)
    want = tref.paged_kv_cache_attention(
        *(torch.as_tensor(a) for a in (q, pools[0], qc["k_scale"], pools[1],
                                       pools[2], tbl, pos)), 8)
    tbl2 = tbl.copy()
    tbl2[0, 2:] = [0, -1]
    got = tref.paged_kv_cache_attention(
        *(torch.as_tensor(a) for a in (q, pools[0], qc["k_scale"], pools[1],
                                       pools[2], tbl2, pos)), 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("positions", [[[5], [6]], [[8], [9]], [[5], [1]],
                                       [[3, 4], [6, 7]]])
def test_paged_write_row_drops_like_jax(positions):
    """-1 table entries and positions >= n * page drop the write; the rest
    land where JAX puts them, including when a dropped row's clamped
    target is a kept row's."""
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(4, 4, 2, 3)).astype(np.float32)
    tbl = np.array([[2, -1], [0, 1]], np.int32)
    pos = np.array(positions, np.int32)
    new = rng.normal(size=(2, pos.shape[1], 2, 3)).astype(np.float32)
    want = np.asarray(jkvq.paged_write_row(jnp.asarray(pool),
                                           jnp.asarray(new), jnp.asarray(pos),
                                           jnp.asarray(tbl)))
    got = torch.as_tensor(pool.copy())
    tkvq.paged_write_rows([(got, torch.as_tensor(new))],
                          torch.as_tensor(pos), torch.as_tensor(tbl))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_pages_and_page_count_match_jax():
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(6, 4, 2, 3)).astype(np.float32)
    tbl = np.array([[5, 0, 2], [1, -1, 9]], np.int32)
    np.testing.assert_array_equal(
        tkvq.gather_pages(torch.as_tensor(pool), torch.as_tensor(tbl)).numpy(),
        np.asarray(jkvq.gather_pages(jnp.asarray(pool), jnp.asarray(tbl))))
    for n_tok, page in ((17, 16), (16, 16), (1, 8), (0, 4)):
        assert tkvq.page_count(n_tok, page) == jkvq.page_count(n_tok, page)


def test_paged_cache_bookkeeping():
    """A fresh cache holds only the -1 sentinel; table rows and lengths
    update in place; the byte count covers pools, scales, lengths and
    table."""
    from repro_torch.configs import olmo_1b
    from repro_torch.serve import kv_cache, paging
    cfg = olmo_1b.config().smoke()
    c = paging.init_paged_cache(cfg, 2, 40, 7, 16, torch.float32, "cpu",
                                cache_bits=4)
    assert c.block_tbl.shape == (2, 3) and bool((c.block_tbl == -1).all())
    assert paging.n_pool_pages(c) == 7
    paging.set_table_rows(c, 1, [4, 6])
    assert c.block_tbl.tolist() == [[-1, -1, -1], [4, 6, -1]]
    paging.set_length(c, 1, 19)
    assert c.lengths.tolist() == [0, 19]
    c = paging.advance(c, 3, torch.tensor([True, False]))
    assert c.lengths.tolist() == [3, 19]
    leaf = c.layers["pat"][0]["p0"]
    per_layer = (2 * leaf["pkq"].numel() + 4 * leaf["pv_scale"].numel()
                 + 4 * leaf["k_scale"].numel())
    assert kv_cache.cache_bytes(c) == cfg.n_repeats * per_layer + 8 + 24


def test_splice_prefill_maps_slots_sequentially():
    """splice_prefill gives slot i pages [i * max_pages, (i + 1) *
    max_pages) and refuses a pool smaller than that."""
    from repro_torch.configs import olmo_1b
    from repro_torch.serve import paging
    cfg = olmo_1b.config().smoke()
    rng = np.random.default_rng(3)
    pre = {"pat": [{"p0": {key: torch.as_tensor(rng.normal(
        size=(2, 20, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
        for key in ("k", "v")}} for _ in range(cfg.n_repeats)]}
    c = paging.init_paged_cache(cfg, 2, 32, 4, 16, torch.float32, "cpu")
    c = paging.splice_prefill(c, pre, torch.tensor([20, 11]))
    assert c.block_tbl.tolist() == [[0, 1], [2, 3]]
    assert c.lengths.tolist() == [20, 11]
    for r in range(cfg.n_repeats):
        got = tkvq.gather_pages(c.layers["pat"][r]["p0"]["pk"], c.block_tbl)
        assert torch.equal(got[:, :20], pre["pat"][r]["p0"]["k"])
        assert not got[:, 20:].any()
    small = paging.init_paged_cache(cfg, 2, 32, 3, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="B \\* max_pages"):
        paging.splice_prefill(small, pre, torch.tensor([20, 11]))


def test_unported_paged_paths_raise():
    """Prefill over a paged cache (prefix sharing), the chunked-prefill
    role staging and S > 1 decode name their ROADMAP items."""
    from repro_torch.configs import olmo_1b
    from repro_torch.models import attention as attn
    cfg = olmo_1b.config().smoke()
    gen = torch.Generator().manual_seed(0)
    p = attn.init_gqa(gen, cfg, "cpu")
    bits = {"attn_qkv": 4.0, "attn_wo": 4.0}
    cache = dict(attn.init_gqa_paged_cache(cfg, 4, 16, torch.float32, "cpu"),
                 tbl=torch.zeros((1, 4), dtype=torch.int32))
    x1, x2 = torch.zeros((1, 1, cfg.d_model)), torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="item 9"):
        attn.gqa_apply(p, x2, bits, cfg, "prefill", cache,
                       torch.arange(2)[None])
    with pytest.raises(NotImplementedError, match="item 10"):
        attn.gqa_apply(p, x2, bits, cfg, "decode", cache,
                       torch.arange(2)[None])
    with pytest.raises(NotImplementedError, match="item 10"):
        attn.gqa_apply(p, x1, bits, cfg, "decode",
                       dict(cache, role=torch.zeros(1, dtype=torch.bool)),
                       torch.zeros((1, 1), dtype=torch.long))
