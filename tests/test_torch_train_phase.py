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
