"""qwen2-vl-7b's M-RoPE in the port against the reference, on the
``.smoke()`` config in float32 on the CPU: the same numpy params in both
packages (``convert.from_jax_params``), the same prompts and (3, B, S)
position streams (numpy, from seeds).

With three equal streams M-RoPE is RoPE exactly (each section takes its
own columns' frequencies), and text serving collapses the streams to the
1-D position.  So a port that ignored the sections would pass every
serving test; the forward, loss and gradient tests here drive distinct
streams, Qwen2-VL's (t, h, w) grid of an image followed by text that
continues from the grid's largest position plus one.

Tolerances, each with its reason:
  - ``mrope_angles`` within 1e-6 absolute of the reference's (XLA's
    float32 cos/sin against float64 ones rounded once: an ulp) at every
    position up to 32768, the frequencies bit for bit
    (``test_rope_freqs_against_jax``); bit for bit ``rope_angles`` with
    equal streams (the same angles);
  - the packed forward's logits within 1e-4 * max|logit| of the
    reference's ``apply`` (summation order; ``test_torch_zoo.py``'s bound),
    and the same logits with equal streams at least 1e-3 * max|logit|
    away (the sections are wired);
  - one train step with 2 microbatches: the loss within 1e-5 relative and
    every gradient within ||dg|| / ||g|| <= 1e-3 (``test_torch_train.py``);
  - EAGL's gains within 1e-6 relative, the knapsack takes equal;
  - 16 greedy tokens equal to the reference engine's (uniform over the
    full cache, the 4/2 mix over int8), the port's contiguous and paged
    engines both (the reference engine's own test against its stepwise
    oracle fails on this host, so its engine is the yardstick);
  - the scheduler over a paged full cache with a shared page-aligned
    prefix: every request's tokens equal its solo ``generate`` and the
    reference scheduler's, with at least one suffix prefill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.metrics import alps, eagl as teagl, hawq  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serve import pack_params  # noqa: E402
from repro_torch.train.step import (make_train_step,  # noqa: E402
                                    train_state_from_params)
from test_torch_scheduler import (_assert_same, _engines,  # noqa: E402
                                  _serve_both)
from test_torch_serve import _jax_engine, _port_engine  # noqa: E402
from test_torch_zoo import _make  # noqa: E402

NAME = "qwen2-vl-7b"
POLICY_OF = {"full": "uniform", "quantized": "mixed"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    return _make(NAME)


def vl_streams(b: int, s: int, grid=(4, 4), seed: int = 0) -> np.ndarray:
    """(3, B, S) int32 streams of Qwen2-VL's layout: row r holds a few
    text tokens (a seeded count, different per row), an image of one
    frame on an ``grid`` of patches (temporal stream constant, height and
    width streams the patch's row and column, all offset by the text
    before it), then text continuing from the image's largest position
    plus one."""
    gh, gw = grid
    lead = np.random.default_rng(seed).integers(0, s - gh * gw, b)
    out = np.zeros((3, b, s), np.int32)
    for r, a in enumerate(lead):
        out[:, r, :a] = np.arange(a)
        i = np.arange(gh * gw)
        out[0, r, a:a + gh * gw] = a
        out[1, r, a:a + gh * gw] = a + i // gw
        out[2, r, a:a + gh * gw] = a + i % gw
        rest = s - a - gh * gw
        out[:, r, a + gh * gw:] = a + max(gh, gw) + np.arange(rest)
    return out


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def test_config_registry():
    """The published config and its ``.smoke()`` carry the reference's
    fields; the smoke rule rescales the sections (16, 24, 24) to (4, 6,
    6) at head_dim 32."""
    for want, got in ((configs.get_config(NAME), get_config(NAME)),
                      (configs.get_config(NAME).smoke(),
                       get_config(NAME).smoke())):
        for f in ("name", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_repeats", "norm", "activation", "rope",
                  "rope_base", "mrope_sections", "tie_embeddings"):
            assert getattr(got, f) == getattr(want, f), f
    assert get_config(NAME).smoke().mrope_sections == (4, 6, 6)


@pytest.mark.parametrize("dim,sections,base,top", [
    (128, (16, 24, 24), 1e6, 32768), (32, (4, 6, 6), 1e6, 32768)])
def test_mrope_angles_match_jax(dim, sections, base, top):
    """Distinct streams, full size and smoke size, positions below 32768
    (the frequencies are the reference's bit for bit)."""
    pos = np.random.default_rng(dim).integers(0, top, (3, 2, 64)).astype(
        np.int32)
    jc, js = jcommon.mrope_angles(jnp.asarray(pos), dim, sections, base)
    tc, ts = common.mrope_angles(torch.from_numpy(pos), dim, sections, base)
    assert tc.shape == ts.shape == (2, 64, dim // 2)
    assert tc.dtype == ts.dtype == torch.float32
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-6


def test_equal_streams_are_rope_exactly():
    pos = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4096, (2, 48)))
    for dim, sections in ((128, (16, 24, 24)), (32, (4, 6, 6))):
        mc, ms = common.mrope_angles(pos[None].expand(3, 2, 48), dim,
                                     sections, 1e6)
        rc, rs = common.rope_angles(pos, dim, 1e6)
        assert torch.equal(mc, rc) and torch.equal(ms, rs)
    with pytest.raises(ValueError, match="sections"):
        common.mrope_angles(pos[None].expand(3, 2, 48), 32, (4, 6, 5), 1e6)


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
def test_packed_forward_distinct_streams_matches_jax(qwen, policy):
    """The packed prefill forward (uniform 4-bit and the 4/2 mix) on
    distinct streams against the reference's ``apply``; with equal streams
    the logits move (the control)."""
    cfg, jcfg = qwen["cfg"], qwen["jcfg"]
    ja, ta = qwen["arrays"][policy]
    tokens, streams = _tokens(2, 32, 7), vl_streams(2, 32)
    assert (streams[0] != streams[1]).any()
    want = jax.jit(lambda p, pa, t, m: jtf.apply(
        p, pa, {"tokens": t, "mrope_positions": m}, jcfg, local_context(),
        mode="prefill")[0])(
            jpack(qwen["jparams"], ja, jcfg, layout="unrolled"),
            jax.tree.map(jnp.asarray, ja), jnp.asarray(tokens),
            jnp.asarray(streams))
    packed = pack_params(qwen["tparams"], ta, cfg, device="cpu")
    with torch.no_grad():
        got, _ = ttf.apply(packed, ta, torch.from_numpy(tokens), cfg,
                           mode="prefill",
                           mrope_positions=torch.from_numpy(streams))
        text, _ = ttf.apply(packed, ta, torch.from_numpy(tokens), cfg,
                            mode="prefill", mrope_positions=torch.from_numpy(
                                streams[:1]).expand(3, 2, 32))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (2, 32, cfg.vocab)
    top = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() <= 1e-4 * top
    assert (text - got).abs().max() >= 1e-3 * top


def test_missing_or_stray_streams_raise(qwen):
    """An M-RoPE config without streams, or with streams of another
    shape, raises; so does a RoPE config given streams."""
    cfg, ta = qwen["cfg"], qwen["arrays"]["uniform"][1]
    tokens = torch.from_numpy(_tokens(2, 8, 1))
    with pytest.raises(ValueError, match="mrope_positions"):
        ttf.apply(qwen["tparams"], ta, tokens, cfg, mode="prefill")
    with pytest.raises(ValueError, match="mrope_positions"):
        ttf.loss_fn(qwen["tparams"], ta, {"tokens": tokens,
                                          "labels": tokens}, cfg)
    with pytest.raises(ValueError, match=r"\(3, 2, 8\)"):
        ttf.apply(qwen["tparams"], ta, tokens, cfg, mode="prefill",
                  mrope_positions=torch.zeros((3, 2, 7), dtype=torch.long))
    olmo = get_config("olmo-1b").smoke()
    with pytest.raises(ValueError, match="no mrope_positions"):
        ttf.apply(ttf.init_params(olmo, 0, "cpu"),
                  ttf.build_policy(olmo).as_arrays(), tokens, olmo,
                  mode="prefill", mrope_positions=torch.zeros(
                      (3, 2, 8), dtype=torch.long))


class _Capture:
    """An optimizer that keeps the gradients it is handed (port)."""
    def __init__(self, leaves):
        self._leaves, self.grads = leaves, None

    def leaves(self):
        return self._leaves

    def step(self, grads):
        self.grads = grads


class _JCapture:
    """The same for the reference's ``optimizer.update`` protocol."""
    def init(self, params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(self, grads, opt_state, params):
        return params, grads


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _vl_batch(seed, b=4, s=32):
    tok = _tokens(b, s + 1, seed)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mrope_positions": vl_streams(b, s, seed=seed)}


def test_train_step_two_microbatches_matches_jax(qwen):
    """One train step of the 4/2 mix with ``n_microbatches=2`` over a
    batch whose rows carry different streams (a split on the streams'
    dim 0 would pair rows with another row's streams): the loss and every
    gradient against the reference's train step."""
    cfg, jcfg = qwen["cfg"], qwen["jcfg"]
    ja, ta = qwen["arrays"]["mixed"]
    batch = _vl_batch(3)
    js = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                          params=qwen["jparams"],
                          opt_state=_JCapture().init(qwen["jparams"]),
                          policy=jax.tree.map(jnp.asarray, ja))
    js2, jm = jax.jit(jstep.make_train_step(
        jcfg, local_context(), _JCapture(), n_microbatches=2))(
            js, jax.tree.map(jnp.asarray, batch))
    params = from_jax_params(jax.tree.map(np.asarray, qwen["jparams"]),
                             device="cpu")
    st = train_state_from_params(params, _Capture, ta)
    st, m = make_train_step(cfg, n_microbatches=2)(
        st, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    want = tree.flatten(from_jax_params(
        jax.tree.map(np.asarray, js2.opt_state), device="cpu"))
    got = st.optimizer.grads
    assert len(want) == len(got) == len(tree.leaves(st.params))
    for (path, w), g in zip(want, got):
        assert torch.isfinite(g).all() and float(w.abs().max()) > 0, path
        assert _rel(g, w) <= 1e-3, (path, _rel(g, w))


def test_selection_losses_carry_the_streams(qwen):
    """HAWQ's loss and an ALPS probe hand the batch to ``loss_fn`` whole:
    the streams reach the model (the loss with them equals ``loss_fn``'s,
    and differs from the text streams')."""
    cfg, ta = qwen["cfg"], qwen["arrays"]["mixed"][1]
    batch = {k: torch.from_numpy(v) for k, v in _vl_batch(5, b=2).items()}
    text = dict(batch, mrope_positions=torch.arange(32).expand(3, 2, 32))
    params = from_jax_params(jax.tree.map(np.asarray, qwen["jparams"]),
                             device="cpu")
    with torch.no_grad():
        want = ttf.loss_fn(params, ta, batch, cfg)[0]
        got = hawq.hvp_loss(cfg, ta)(params, batch)
        other = hawq.hvp_loss(cfg, ta)(params, text)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(other) != pytest.approx(float(want), rel=1e-6)
    st = train_state_from_params(params, AdamW, ta)
    probe = alps.make_probe(st, make_train_step(cfg), lambda i: batch)
    assert probe(qwen["tpol"].apply_selection(tk.select_for_budget(
        qwen["tpol"], tk.synthetic_gains(qwen["tpol"]), 0.7).take))[
        "loss"] == pytest.approx(float(want), rel=1e-5)


def test_eagl_matches_jax(qwen):
    jp, tp = qwen["jpol"], qwen["tpol"]
    want = jeagl.eagl_gains(jp, lambda u, t: jtf.fetch_unit_tensor(
        qwen["jparams"], u, t), impl="ref")
    got = teagl.eagl_gains(tp, lambda u, t: ttf.fetch_unit_tensor(
        qwen["tparams"], u, t))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    assert (tk.select_for_budget(tp, got, 0.7).take
            == jk.select_for_budget(jp, want, 0.7).take)


@pytest.mark.parametrize("cache", ["full", "quantized"])
def test_greedy_matches_reference_engine(qwen, cache):
    """16 greedy tokens of two prompts: the port's contiguous and paged
    engines give the reference engine's (uniform over the full cache,
    the 4/2 mix over int8)."""
    policy = POLICY_OF[cache]
    prompt = _tokens(2, 12, 20)
    want = np.asarray(_jax_engine(qwen, policy, cache, 8).generate(
        jnp.asarray(prompt), n_new=16))
    for layout in ("contiguous", "paged"):
        got = _port_engine(qwen, policy, cache, 8, layout).generate(prompt,
                                                                    16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=layout)


def test_scheduler_shares_prefixes(qwen, monkeypatch):
    """The scheduler over a paged full cache: two of four requests share a
    one-page prompt prefix with an earlier one (suffix prefills at
    shifted positions), one repeats a prompt; each request's tokens equal
    its solo ``generate`` and the reference scheduler's."""
    rng = np.random.default_rng(31)
    head = rng.integers(0, 512, 16).tolist()
    a = head + rng.integers(0, 512, 5).tolist()
    b = head + rng.integers(0, 512, 9).tolist()
    c = rng.integers(0, 512, 7).tolist()
    reqs = [(f"r{i}", p, 6, None) for i, p in enumerate((a, b, c, a))]
    setup = {"jcfg": qwen["jcfg"], "cfg": qwen["cfg"],
             "jpacked": jpack(qwen["jparams"], qwen["arrays"]["uniform"][0],
                              qwen["jcfg"]),
             "ja": jax.tree.map(jnp.asarray, qwen["arrays"]["uniform"][0]),
             "ta": qwen["arrays"]["uniform"][1],
             "tpacked": pack_params(qwen["tparams"],
                                    qwen["arrays"]["uniform"][1],
                                    qwen["cfg"], device="cpu"),
             "jengines": {}}
    je, te = _engines(setup, "full", 8, "paged")
    suffixes = []
    real = te.prefill_suffix

    def counted(*args, **kw):
        suffixes.append(args[2])
        return real(*args, **kw)
    monkeypatch.setattr(te, "prefill_suffix", counted)
    js, ts = _serve_both(je, te, reqs, 2)
    assert suffixes and all(off == 16 for off in suffixes)
    assert ts.registry.hits >= 2
    _assert_same(js, ts)
    for uid, prompt, n, _ in reqs:
        solo = te.generate(np.asarray([prompt]), n)[0].tolist()
        assert ts.completed[uid].tokens == solo, uid


@pytest.mark.parametrize("half,base", [(64, 1e6), (64, 1e4), (64, 5e5),
                                       (40, 1e4), (16, 1e6)])
def test_rope_freqs_against_jax(half, base):
    """The rotation frequencies (the power in float64, rounded once)
    against the reference's (XLA's, correctly rounded): bit for bit at
    head_dims 128, 80 and 32 (ROADMAP Queue 3 entry 7, closed); so RoPE's
    and M-RoPE's cos and sin are within 1e-6 of the reference's (an ulp of
    cos/sin, evaluated apart) at every position up to p = 32768."""
    want = np.asarray(base ** (-jnp.arange(0, half, dtype=jnp.float32)
                               / half))
    got = common.rope_freqs(half, base, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    pos = np.random.default_rng(half).integers(0, 32768, (3, 2, 64))
    pos[:, 0, -1] = 32768
    jc, js = jcommon.rope_angles(jnp.asarray(pos[0]), 2 * half, base)
    tc, ts = common.rope_angles(torch.from_numpy(pos[0]), 2 * half, base)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-6
    secs = (half // 4, half // 4, half - 2 * (half // 4))
    jc, js = jcommon.mrope_angles(jnp.asarray(pos), 2 * half, secs, base)
    tc, ts = common.mrope_angles(torch.from_numpy(pos), 2 * half, secs, base)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-6


def test_greedy_past_position_1024_at_head_dim_128():
    """Free-running greedy decoding at positions 1060-1067 on a head_dim
    128 config at base 1e6 (internlm2-1.8b's smoke config, 2 query heads
    of 128 on one KV head, one layer): the port's engine gives the
    reference engine's tokens, where the frequencies' last ulp moves
    cos and sin by about 8e-6."""
    from repro.serve import EngineSpec as JSpec
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import EngineSpec, ServeEngine
    made = _make("internlm2-1.8b", n_heads=2, n_kv_heads=1, head_dim=128,
                 n_repeats=1)
    ja, ta = made["arrays"]["uniform"]
    s, n_new, max_seq = 1060, 8, 1072
    prompt = _tokens(1, s, 3)
    je = JEngine(cfg=made["jcfg"], params=jpack(made["jparams"], ja,
                                                made["jcfg"]),
                 policy_arrays=jax.tree.map(jnp.asarray, ja),
                 ctx=local_context(), max_seq=max_seq,
                 spec=JSpec(weights="packed", cache="full"))
    want = np.asarray(je.generate(jnp.asarray(prompt), n_new=n_new))
    te = ServeEngine(made["cfg"], pack_params(made["tparams"], ta,
                                              made["cfg"], device="cpu"),
                     ta, max_seq, EngineSpec(cache="full"), device="cpu")
    np.testing.assert_array_equal(te.generate(prompt, n_new).numpy(), want)
