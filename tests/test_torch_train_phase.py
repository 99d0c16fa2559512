"""chip_smoke.py's train and alps phases rehearsed on the CPU at olmo-1b's
smoke config: the kernel wrappers are stood in for by their plain versions
(counted as launches), the card's clocks and memory calls by no-ops, so
the phases' control flow, gates and launch arithmetic run as they will on
the card."""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.kernels import cuda, ops, ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes at
    once (pytest -n 6), and PyTorch's default of a thread a core
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_card(monkeypatch):
    """The "auto" path on CPU tensors: ops route to the cuda wrappers, and
    the wrappers run the plain versions, each call counted in
    cuda.LAUNCHES."""
    monkeypatch.setattr(ops, "use_kernel", lambda t, impl: impl == "auto")

    def counted(name, fn):
        def run(*a, **k):
            cuda.LAUNCHES[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(cuda, "lsq_fakequant", counted(
        "lsq_fakequant", lambda x, s, b: ref.lsq_fakequant_grouped(x, s, b)
        if isinstance(s, list) else ref.lsq_fakequant(x, s, b)))
    monkeypatch.setattr(cuda, "lsq_fakequant_bwd", counted(
        "lsq_fakequant_bwd", ref.lsq_fakequant_bwd))
    monkeypatch.setattr(cuda, "histogram", counted("histogram",
                                                   ref.histogram))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_breakdown", lambda fn, top=20: (
        fn(), {"wall_ms": 1.0, "device_ms": 0.5, "idle_share": 0.5,
               "dtoh_copies": 0, "device_ops": 1, "qmm_gemv_ms": 0.0,
               "decode_attention_ms": 0.0, "lsq_fakequant_ms": 0.0,
               "lsq_fakequant_bwd_ms": 0.0, "top": []})[1])
    monkeypatch.setattr(chip_smoke, "TRAIN_B", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_S", 32)
    monkeypatch.setattr(chip_smoke, "ALPS_B", 2)
    monkeypatch.setattr(chip_smoke, "ALPS_S", 32)


def test_train_and_alps_phases_rehearsed(cpu_card):
    cfg = olmo_1b.config().smoke()
    dev = torch.device("cpu")
    state, rec = chip_smoke.phase_train(cfg, dev, "cpu rehearsal")
    sites = chip_smoke.lsq_sites(cfg)
    n = sites["activations"] + sites["weights"]
    steps = chip_smoke.TRAIN_STEPS
    assert rec["launches"]["lsq_fakequant_bwd"] == steps * n
    assert rec["launches"]["lsq_fakequant"] == steps * (
        n + sites["recomputed"])
    assert rec["launches_step1_grads"]["lsq_fakequant_bwd"] == n
    assert rec["t1_loss_equal"] and rec["t3_margin"] > 0
    assert rec["grads"]["w_equal"] == 7 * cfg.n_repeats + 1
    assert not rec["grads"]["bad"] and state.step == steps + 1
    alps = chip_smoke.phase_alps(cfg, dev, state, "cpu rehearsal")
    assert alps["units"] == 8 and alps["a1_params_equal"] and alps[
        "a2_equal"]
    assert len(alps["a3_rel"]) == chip_smoke.ALPS_REF_UNITS
    assert alps["launches"]["lsq_fakequant_bwd"] == 8 * 2 * n
    assert 0 <= alps["overlap"] <= 8


def test_hawq_and_frontier_phases_rehearsed(cpu_card, monkeypatch):
    """The hawq and frontier phases after the train and alps phases: H1-H4
    and F1-F4 hold, the products make no backward launch, and the
    fine-tunes' launches are the points x steps x a train step's."""
    monkeypatch.setattr(chip_smoke, "FRONTIER_STEPS", 2)
    cfg = olmo_1b.config().smoke()
    dev = torch.device("cpu")
    state, _ = chip_smoke.phase_train(cfg, dev, "cpu rehearsal")
    alps = chip_smoke.phase_alps(cfg, dev, state, "cpu rehearsal")
    hawq = chip_smoke.phase_hawq(cfg, dev, state, alps, "cpu rehearsal")
    sites = chip_smoke.lsq_sites(cfg)
    n = sites["activations"] + sites["weights"]
    assert hawq["launches"]["lsq_fakequant_bwd"] == 0
    assert hawq["launches"]["lsq_fakequant"] > 0
    assert hawq["h3_rel"] == 0.0 and hawq["h2_params_equal"]
    assert len(hawq["gains"]) == 8
    from repro_torch.models import transformer as tf
    front = chip_smoke.phase_frontier(cfg, dev, state,
                                      chip_smoke.selection_methods(
                                          tf.build_policy(cfg), alps, hawq),
                                      "cpu rehearsal")
    points = len(front["points"])
    assert points == 6 * len(chip_smoke.FRONTIER_BUDGETS)
    assert front["finetune_launches"]["lsq_fakequant_bwd"] == points * 2 * n
    assert front["finetune_launches"]["lsq_fakequant"] == points * 2 * (
        n + sites["recomputed"])
    assert front["f3_params_equal"]
    assert 0 <= front["joint"]["cache_int8"] <= front["joint"]["cache_units"]


def test_phases_refuse_a_forward_only_kernel_in_training(cpu_card,
                                                         monkeypatch):
    """T5: a train step that reached flash_attention would fail the
    phase (here the prefill branch is forced on for train mode)."""
    from repro_torch.models import attention
    real = attention.gqa_apply

    def leaky(*args, **kwargs):
        cuda.LAUNCHES["flash_attention"] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(attention, "gqa_apply", leaky)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 4)
    with pytest.raises(RuntimeError, match="T5: flash_attention"):
        chip_smoke.phase_train(olmo_1b.config().smoke(),
                               torch.device("cpu"), "cpu rehearsal")


def test_dbrx_method_phase_rehearsed(cpu_card, monkeypatch):
    """chip_smoke's dbrx method phase at dbrx-132b's smoke size (4
    experts, top-2, one layer, float32): T1-T5 with int8 moments (T4: 3 +
    2E activation and 5 + 3E weight sites a layer, 1 and 2 edges), A1-A3
    with two experts among A3's units, H1-H4 with each expert its own
    gain, F1-F4 over EAGL, ALPS and HAWQ-v3 at two budgets; and the sites
    at the card's 16 experts: 36 activation and 55 weight sites a layer."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(chip_smoke, "FRONTIER_STEPS", 2)
    # quickstart's rate for a smoke model (chip_smoke.LR is full width's)
    monkeypatch.setattr(chip_smoke, "LR", 2e-3)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: type("Card", (), {"total_memory": 1}))
    full = get_config("dbrx-132b").replace(n_repeats=1)
    assert chip_smoke.lsq_sites(full) == {"activations": 36, "weights": 55,
                                          "recomputed": 35}
    cfg = get_config("dbrx-132b").smoke().replace(n_repeats=1)
    rec = chip_smoke.phase_dbrx_method(cfg, torch.device("cpu"),
                                       "cpu rehearsal")
    e = cfg.n_experts
    sites = chip_smoke.lsq_sites(cfg)
    assert sites == {"activations": 3 + 2 * e + 1, "weights": 5 + 3 * e + 2,
                     "recomputed": 3 + 2 * e}
    train = rec["train"]
    assert train["state_dtype"] == "int8" and train["t1_loss_equal"]
    assert train["grads"]["unread"] == 1 and not train["grads"]["bad"]
    assert rec["units"] == 2 + 2 * e and rec["experts"] == 2 * e
    assert len(rec["a3_experts"]) == 2
    assert rec["alps"]["a1_params_equal"] and rec["alps"]["a2_equal"]
    assert rec["hawq"]["expert_banks"] == 2
    assert rec["hawq"]["banks_with_equal_gains"] == []
    front = rec["frontier"]
    assert len(front["points"]) == 3 * len(chip_smoke.DBRX_BUDGETS)
    assert front["f3_params_equal"]


@pytest.mark.parametrize("n_repeats", [0, 1])
def test_dsv3_method_phase_rehearsed(cpu_card, monkeypatch, n_repeats):
    """chip_smoke's deepseek-v3 method phase at deepseek-v3-671b's smoke
    size (one MLA + SwiGLU prefix block, float32; with n_repeats=1 also an
    MLA + MoE layer of 8 experts and the shared expert) with the MTP loss:
    T1-T5 with int8 moments (T4 from ``lsq_sites``: MLA's 3 activation
    and 6 weight sites, a SwiGLU's 2 and 3, the MTP head's 3 and 3 at the
    edges), T2 counting wk_b's and wv_b's activation steps as unread, A1-A3
    over one MLA and one SwiGLU unit among A3's, H1-H4, F1-F4 over EAGL,
    ALPS and HAWQ-v3 at two budgets; and the sites at the card's widths:
    the 3 prefix blocks alone (DSV3_TRAIN_DEPTH) and with the served MoE
    layer of 256 experts (DSV3_DEPTH)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    monkeypatch.setattr(chip_smoke, "FRONTIER_STEPS", 2)
    # quickstart's rate for a smoke model (DSV3_LR is full width's), and
    # 256 tokens a step (the parity tests' 4 x 64): at 2 x 32 the smoke
    # model's loss moves by less than one batch's noise in 16 steps, at any
    # rate, and T3 reads noise
    monkeypatch.setattr(chip_smoke, "DSV3_LR", 2e-3)
    monkeypatch.setattr(chip_smoke, "ALPS_B", 4)
    monkeypatch.setattr(chip_smoke, "ALPS_S", 64)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: type("Card", (), {"total_memory": 1}))
    name = "deepseek-v3-671b"
    full = get_config(name).replace(n_repeats=chip_smoke.DSV3_TRAIN_DEPTH)
    full_units = tf.build_policy(full).selectable_units()
    assert len(full_units) == 18
    assert [u.name for u in full_units if u.name in [
        "prefix0.attn_q_a.L0", "prefix1.attn_kv_b.L0",
        "prefix2.mlp_gateup.L0", "prefix0.mlp_down.L0"]] == [
            "prefix0.attn_q_a.L0", "prefix0.mlp_down.L0",
            "prefix1.attn_kv_b.L0", "prefix2.mlp_gateup.L0"]
    assert chip_smoke.DSV3_TRAIN_DEPTH == 0
    assert chip_smoke.lsq_sites(get_config(name).replace(
        n_repeats=chip_smoke.DSV3_TRAIN_DEPTH)) == {
            "activations": 18, "weights": 32, "recomputed": 15}
    assert chip_smoke.lsq_sites(get_config(name).replace(
        n_repeats=chip_smoke.DSV3_DEPTH)) == {
            "activations": 536, "weights": 810, "recomputed": 533}
    assert {("attn", "wk_b", "sa"), ("attn", "wv_b", "sa")} <= set(
        chip_smoke.UNREAD_LEAVES)
    cfg = get_config(name).smoke().replace(n_repeats=n_repeats)
    e = cfg.n_experts
    moe = {"activations": 6 + 2 * e, "weights": 10 + 3 * e}
    assert chip_smoke.lsq_sites(cfg) == {
        "activations": 5 + moe["activations"] * n_repeats + 3,
        "weights": 9 + moe["weights"] * n_repeats + 5,
        "recomputed": 5 + moe["activations"] * n_repeats}
    rec = chip_smoke.phase_dsv3_method(cfg, torch.device("cpu"),
                                       "cpu rehearsal")
    train = rec["train"]
    assert train["state_dtype"] == "int8" and train["t1_loss_equal"]
    assert not train["grads"]["bad"]
    # wk_b's and wv_b's in each MLA block, and the up bank's in a MoE layer
    assert train["grads"]["unread"] == 2 * (1 + n_repeats) + n_repeats
    units = tf.build_policy(cfg).selectable_units()
    assert rec["units"] == len(units)
    # smoke's q_lora and kv_lora of 64 pin attn_q_b and attn_kv_b at 8 bits
    slots = [u.split(".")[1] for u in rec["a3_units"]]
    assert slots == ["attn_q_a", "mlp_gateup", "mlp_down"]
    assert rec["a3_units"][0] == units[0].name == "prefix0.attn_q_a.L0"
    assert rec["alps"]["a1_params_equal"] and rec["alps"]["a2_equal"]
    assert set(rec["alps"]["a3_rel"]) == set(rec["a3_units"])
    assert rec["hawq"]["h2_params_equal"] and rec["hawq"]["h3_rel"] == 0.0
    assert set(k.split("/")[0] for k in rec["hawq"]["h3_traces"]["ref"]) \
        == set(rec["a3_units"])
    front = rec["frontier"]
    assert len(front["points"]) == 3 * len(chip_smoke.DBRX_BUDGETS)
    assert front["f3_params_equal"]


@pytest.mark.cuda
def test_moments_on_host_round_trip():
    """``chip_smoke.moments_on_host`` on the card (the deepseek-v3 method
    phase's HAWQ-v3): after one train step of deepseek-v3-671b's smoke
    config with int8 AdamW moments, every moment tensor is in host memory
    inside the block, and after it back on the params' device, bit for bit
    what it was."""
    import functools
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import init_train_state, make_train_step
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the moments move between the "
                    "card's memory and the host's")
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v3-671b").smoke().replace(n_repeats=1)
    state = init_train_state(cfg, functools.partial(
        AdamW, learning_rate=1e-3, state_dtype="int8"), 0,
        tf.build_policy(cfg), device=dev)
    state, _ = make_train_step(cfg, impl="ref")(
        state, make_batch(0, 0, 2, 32, cfg.vocab, device=dev))
    opt, leaves = state.optimizer, tree.leaves(state.params)

    def moments():
        return [t for p in leaves for t in tree.leaves(opt.state[p])]
    before = [t.clone() for t in moments()]
    assert before and all(t.is_cuda for t in before)
    with chip_smoke.moments_on_host(state):
        assert all(t.device.type == "cpu" for t in moments())
    after = moments()
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)
