"""The rest of the dense zoo in the port — internlm2-1.8b, deepseek-7b,
granite-20b (MQA) and hubert-xlarge (frame embeddings, no RoPE) — against
the reference on each ``.smoke()`` config in float32 on the CPU: the same
numpy params in both packages (``convert.from_jax_params``), the same
prompts and frame embeddings (numpy, from a seed).

Tolerances, each with its reason:
  - the registry's fields exactly;
  - prefill logits within 1e-4 * max|logit| of the JAX packed engine (the
    engines differ in summation order only; the bound of
    ``test_torch_serve.py``);
  - 16 greedy tokens equal to the JAX packed engine's over full and int8
    caches, contiguous and paged (both port layouts against the JAX
    contiguous engine, which the JAX package holds equal to its paged
    one);
  - the int4 cache is held step by step in ``test_torch_zoo_serve.py``
    (a file of its own, so the two run in parallel test processes);
  - packed params byte-equal, resident bytes and the policy exact;
  - EAGL's gains within 1e-6 relative (exact counts; the float32 entropy
    sum), the knapsack takes equal;
  - hubert-xlarge's packed forward within 1e-4 * max|logit| of the
    reference's ``apply(mode="prefill")`` on ``batch={"embeds": ...}``.

Each decoder runs one JAX engine a cache kind (the uniform policy over
the full cache, the mixed 4/2 policy over int8) and reads its prefill
logits from the same compiled prefill, so the file stays within a minute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.core.metrics import eagl as jeagl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel.context import local_context  # noqa: E402
from repro.serve import pack_params as jpack  # noqa: E402
from repro.serve import residency as jres  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.core.metrics import eagl as teagl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import EngineSpec, pack_params, residency  # noqa: E402
from test_torch_serve import (_compare_packed, _jax_engine,  # noqa: E402
                              _port_engine)

DECODERS = ("internlm2-1.8b", "deepseek-7b", "granite-20b")
ZOO = DECODERS + ("hubert-xlarge",)
# granite's smoke config keeps one KV head for 4 query heads; this one puts
# 12 on it, so the plain attention runs a group above 4
MQA = {"n_heads": 12, "n_kv_heads": 1, "head_dim": 16}
POLICY_OF = {"full": "uniform", "quantized": "mixed"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make(name, **over):
    """Both packages' smoke config of ``name`` (with ``over`` replaced on
    both), params from JAX's PRNGKey(0) carried across, and the uniform
    and mixed (knapsack at 0.7 on synthetic gains) policy arrays, in
    ``test_torch_serve``'s setup layout."""
    jcfg = configs.get_config(name).smoke().replace(**over)
    cfg = get_config(name).smoke().replace(**over)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jpol, tpol = jtf.build_policy(jcfg), ttf.build_policy(cfg)
    jtake = jk.select_for_budget(jpol, jk.synthetic_gains(jpol), 0.7).take
    ttake = tk.select_for_budget(tpol, tk.synthetic_gains(tpol), 0.7).take
    assert ttake == jtake
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "tparams": tparams,
            "jpol": jpol, "tpol": tpol,
            "arrays": {"uniform": (jpol.as_arrays(), tpol.as_arrays()),
                       "mixed": (jpol.apply_selection(jtake).as_arrays(),
                                 tpol.apply_selection(ttake).as_arrays())},
            "jengines": {}}


@pytest.fixture(scope="module")
def zoo():
    made = {}

    def get(name, **over):
        key = (name,) + tuple(sorted(over.items()))
        if key not in made:
            made[key] = _make(name, **over)
        return made[key]
    return get


def _prompt():
    """Two 12-token prompts (the second of 7 valid tokens when a length is
    given), the shape every engine of the file compiles for."""
    return np.random.default_rng(20).integers(0, 512, (2, 12)).astype(
        np.int32)


@pytest.mark.parametrize("name", ZOO)
def test_config_registry(name):
    """Every field of the published config and of its ``.smoke()`` is the
    reference's (dtypes by name)."""
    for want, got in ((configs.get_config(name), get_config(name)),
                      (configs.get_config(name).smoke(),
                       get_config(name).smoke())):
        for f in ("name", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_repeats", "norm", "activation", "rope",
                  "rope_base", "causal", "embed_input", "tie_embeddings"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert [(b.mixer, b.ffn, b.d_ff) for b in got.pattern] == [
            (b.mixer, b.ffn, b.d_ff) for b in want.pattern]
        assert got.prefix == () and want.prefix == ()
        for f in ("param_dtype", "compute_dtype", "cache_dtype"):
            assert (str(getattr(got, f)).replace("torch.", "")
                    == jnp.dtype(getattr(want, f)).name), (name, f)


@pytest.mark.parametrize("cache", ["full", "quantized"])
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_logits_match(zoo, name, cache):
    """The uniform policy's prefill (full-cache engine) and the mixed
    policy's (int8 engine), unequal lengths, within 1e-4 * max|logit|;
    the first layer's K too."""
    s = zoo(name)
    prompt, lengths = _prompt(), np.array([12, 7], np.int32)
    policy = POLICY_OF[cache]
    want, jpre = _jax_engine(s, policy, cache, 8).prefill(
        jnp.asarray(prompt), jnp.asarray(lengths))
    got, tpre = _port_engine(s, policy, cache, 8).prefill(
        torch.as_tensor(prompt), torch.as_tensor(lengths))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    jk0 = np.asarray(jax.tree.leaves(jpre)[0])[0]
    tk0 = tpre["pat"][0]["p0"]["k"].numpy()
    assert np.abs(tk0 - jk0).max() <= 1e-4 * np.abs(jk0).max()


@pytest.mark.parametrize("cache", ["full", "quantized"])
@pytest.mark.parametrize("name", DECODERS)
def test_greedy_matches_jax(zoo, name, cache):
    """16 greedy tokens of two prompts: the port's contiguous and paged
    engines both give the JAX packed engine's (uniform over the full
    cache, mixed over int8)."""
    s = zoo(name)
    policy = POLICY_OF[cache]
    want = np.asarray(_jax_engine(s, policy, cache, 8).generate(
        jnp.asarray(_prompt()), n_new=16))
    for layout in ("contiguous", "paged"):
        got = _port_engine(s, policy, cache, 8, layout).generate(_prompt(),
                                                                 16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=layout)


def test_mqa_group_of_12_matches_jax(zoo):
    """granite's blocks with 12 query heads on one KV head: the prefill's
    repeated K/V and the full cache's decode attention take a group above
    4; 16 greedy tokens, contiguous and paged, equal JAX's.  (Over a
    quantized cache this model's free-running tokens part on a V code's
    rounding tie, ROADMAP Queue 3 entry 1: ``test_torch_zoo_serve.py``
    steps its int4 cache in isolation instead.)"""
    s = zoo("granite-20b", **MQA)
    assert s["cfg"].n_heads // s["cfg"].n_kv_heads == 12
    want = np.asarray(_jax_engine(s, "mixed", "full", 8).generate(
        jnp.asarray(_prompt()), n_new=16))
    for layout in ("contiguous", "paged"):
        got = _port_engine(s, "mixed", "full", 8, layout).generate(
            _prompt(), 16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=layout)


@pytest.mark.parametrize("name", ZOO)
def test_pack_params_byte_equal(zoo, name):
    """The mixed policy's packed tree, leaf for leaf, and its resident
    bytes equal the reference's ``layout="unrolled"`` packing."""
    s = zoo(name)
    ja, ta = s["arrays"]["mixed"]
    want = jpack(s["jparams"], ja, s["jcfg"], layout="unrolled")
    got = pack_params(s["tparams"], ta, s["cfg"], device="cpu")
    assert _compare_packed(want, got) > 0
    assert residency.resident_bytes(got) == jres.resident_bytes(want)
    bits = {p.bits for layer in got["pat"] for blk in layer.values()
            for grp in (blk["attn"], blk["mlp"]) for p in grp.values()}
    assert bits == {2, 4}


@pytest.mark.parametrize("name", ZOO)
def test_eagl_matches_jax(zoo, name):
    """EAGL's gains of every selectable unit within 1e-6 relative; the
    knapsack takes at 0.7 equal."""
    s = zoo(name)
    jp, tp = s["jpol"], s["tpol"]
    want = jeagl.eagl_gains(jp, lambda u, t: jtf.fetch_unit_tensor(
        s["jparams"], u, t), impl="ref")
    got = teagl.eagl_gains(tp, lambda u, t: ttf.fetch_unit_tensor(
        s["tparams"], u, t))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), k
    assert (tk.select_for_budget(tp, got, 0.7).take
            == jk.select_for_budget(jp, want, 0.7).take)


def test_policy_units_match_jax(zoo):
    """Every unit and cache unit of each smoke policy is the reference's;
    hubert-xlarge has no embedding unit and no cache unit, the decoders a
    pinned embedding and head."""
    for name in ZOO:
        s = zoo(name)
        jp, tp = s["jpol"], s["tpol"]
        assert [(u.name, u.tensors, u.n_params, u.macs_per_token,
                 u.in_features, u.pinned_bits) for u in tp.units] == [
            (u.name, tuple(u.tensors), u.n_params, u.macs_per_token,
             u.in_features, u.pinned_bits) for u in jp.units], name
        assert [(c.name, c.kv_elems_per_token) for c in tp.cache_units] == [
            (c.name, c.kv_elems_per_token) for c in jp.cache_units], name
        has_embed = any(u.group == "embed" for u in tp.units)
        assert has_embed == (name != "hubert-xlarge")
        assert bool(tp.cache_units) == (name != "hubert-xlarge")


def test_hubert_has_no_token_table(zoo):
    """No ``embed`` leaf in either package's params (the reference's
    ``init_params`` skips it under ``embed_input``), and the port's own
    ``init_params`` agrees; without embeds the forward refuses."""
    s = zoo("hubert-xlarge")
    assert "embed" not in s["jparams"] and "embed" not in s["tparams"]
    own = ttf.init_params(s["cfg"], seed=0, device="cpu")
    assert set(own) == set(s["tparams"]) == {"pat", "final_norm", "head"}
    with pytest.raises(ValueError, match="embeds"):
        ttf.apply(own, s["tpol"].as_arrays(), None, s["cfg"], mode="prefill")


def test_hubert_packed_forward_matches_jax(zoo):
    """The packed forward of the mixed 4/2 policy (``apply(...,
    embeds=...)``, mode="prefill") on seeded frame embeddings (2 x 32 x d)
    within 1e-4 * max|logit| of the reference's ``apply`` on its packed
    params with ``batch={"embeds": ...}``."""
    s = zoo("hubert-xlarge")
    cfg, jcfg = s["cfg"], s["jcfg"]
    ja, ta = s["arrays"]["mixed"]
    embeds = np.random.default_rng(3).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, pa, e: jtf.apply(
        p, pa, {"embeds": e}, jcfg, local_context(), mode="prefill")[0])(
            jpack(s["jparams"], ja, jcfg, layout="unrolled"),
            jax.tree.map(jnp.asarray, ja), jnp.asarray(embeds))
    with torch.no_grad():
        got, _ = ttf.apply(pack_params(s["tparams"], ta, cfg, device="cpu"),
                           ta, None, cfg, mode="prefill",
                           embeds=torch.from_numpy(embeds))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (2, 32, cfg.vocab)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def test_hubert_refused_by_the_engine():
    """An encoder has no autoregressive decode: ``EngineSpec.validate``
    refuses hubert-xlarge as it refuses bert-base, naming ``embeds=``."""
    with pytest.raises(ValueError, match="autoregressive.*embeds="):
        EngineSpec().validate(get_config("hubert-xlarge"))


@pytest.mark.parametrize("s", [100, 1000])
def test_bidirectional_ragged_plain_attention(s):
    """The plain prefill attention, not causal, at a length that is no
    multiple of its 512-row chunk (hubert-xlarge's 1000 frames; the
    reference refuses it): the padded keys are masked, so it is softmax
    attention over the S keys, within 1e-5 of a float64 evaluation."""
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 4, 16)).astype(
        np.float32)) for _ in range(3))
    got = attn.chunked_attention(q, k, v, min(attn.DEFAULT_CHUNK, 64), False)
    w = torch.softmax(torch.einsum("bshd,bthd->bhst", q.double(),
                                   k.double()) * 16 ** -0.5, dim=-1)
    want = torch.einsum("bhst,bthd->bshd", w, v.double())
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


def test_hubert_loss_matches_jax(zoo):
    """The QAT loss on frame embeddings (``loss_fn`` reads
    ``batch["embeds"]``, as the reference's does) within 1e-5 relative of
    the reference's, the mixed policy on raw params (summation order)."""
    s = zoo("hubert-xlarge")
    cfg, jcfg = s["cfg"], s["jcfg"]
    ja, ta = s["arrays"]["mixed"]
    rng = np.random.default_rng(5)
    batch = {"embeds": rng.normal(size=(2, 32, cfg.d_model)).astype(
        np.float32),
             "labels": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    want = float(jax.jit(lambda p, pa, b: jtf.loss_fn(
        p, pa, b, jcfg, local_context())[0])(
            s["jparams"], jax.tree.map(jnp.asarray, ja),
            jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got, _ = ttf.loss_fn(s["tparams"], ta, {
            k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert abs(float(got) - want) <= 1e-5 * abs(want)
