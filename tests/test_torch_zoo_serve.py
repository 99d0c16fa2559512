"""The zoo's serving paths on the CPU: the int4 KV cache of
internlm2-1.8b, deepseek-7b and granite-20b (and of granite's blocks with
12 query heads on one KV head) against the JAX packed engine step by step,
and ``chip_smoke.py``'s zoo and hubert phases rehearsed at smoke size.

Free-running, an int4 (or int8) cache parts from JAX's tokens on rounding
ties of the KV quantizer (ROADMAP Queue 3 entry 1), so it is held in the
step-isolation form of ``test_torch_serve.py``: before every step JAX's
cache is carried into the port, every code the port writes must be JAX's
or a tie within 1e-5 code steps of a rounding boundary, and every step
without a tie must give JAX's logits within 1e-4 * max|logit|.  Three
prompts of 8 steps each, the mixed 4/2 policy, contiguous cache.

The rehearsals run each phase with every kernel wrapper stood in for by
its plain version (counted as the launch it makes on the card), so the
kernel path and the plain path are one code path and the teacher-forced
drifts read 0; what they hold is the control flow, the launches a step
worked out from each config, and the records.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_config  # noqa: E402
from test_torch_serve import _step_isolation  # noqa: E402
from test_torch_serve_mixed import _short_prompts  # noqa: E402
from test_torch_zoo import DECODERS, MQA, _make  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,over", [(n, {}) for n in DECODERS]
                         + [("granite-20b", MQA)],
                         ids=list(DECODERS) + ["granite-20b-group12"])
def test_int4_cache_step_isolation(name, over, monkeypatch):
    ties, steps, tied = _step_isolation(_make(name, **over), "mixed",
                                        "contiguous", monkeypatch,
                                        seeds=range(1, 4), n_steps=8)
    assert steps == 24 and tied <= ties


# ------------------------------------------- chip_smoke's zoo and hubert
class _Card:
    total_memory = 80 << 30


@pytest.fixture
def cpu_card(monkeypatch):
    """The "auto" path on CPU tensors: every kernel wrapper runs its plain
    version (flash_attention the plain path's chunked attention), each
    call counted in cuda.LAUNCHES as the launch it makes on the card (a
    packed 4/2-bit matmul as quant_matmul, a flash call by its dtype's
    kernel), decode on the packed codes as there; the card's clocks,
    memory and profiler are stood in for."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import cuda, ops, ref
    from repro_torch.models import attention as attn
    from repro_torch.serve import ServeEngine
    monkeypatch.setattr(ops, "use_kernel", lambda t, impl: impl == "auto")

    def counted(name, fn):
        def run(*a, **k):
            cuda.LAUNCHES[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(cuda, "lsq_fakequant", counted(
        "lsq_fakequant", lambda x, s, b: ref.lsq_fakequant_grouped(x, s, b)
        if isinstance(s, list) else ref.lsq_fakequant(x, s, b)))
    monkeypatch.setattr(cuda, "kv_decode_attention", counted(
        "kv_decode_attention", ref.kv_cache_attention))
    monkeypatch.setattr(cuda, "paged_kv_decode_attention", counted(
        "paged_kv_decode_attention", ref.paged_kv_cache_attention))
    monkeypatch.setattr(cuda, "histogram", counted("histogram",
                                                   ref.histogram))

    def flash(q, k, v, causal=True):
        # the plain path's own prefill attention, so that the kernel path
        # is the plain path to the bit, in bf16 too; keys longer than the
        # queries (a suffix prefill) align them bottom-right, as the
        # kernel does
        name = ("flash_attention_f32" if q.dtype == torch.float32
                else "flash_attention")
        cuda.LAUNCHES[name] += 1
        group = q.shape[1] // k.shape[1]
        return attn.chunked_attention(
            q.transpose(1, 2), attn._repeat_kv(k.transpose(1, 2), group),
            attn._repeat_kv(v.transpose(1, 2), group),
            min(attn.DEFAULT_CHUNK, k.shape[2]), causal,
            q_offset=k.shape[2] - q.shape[2]).transpose(1, 2)
    monkeypatch.setattr(cuda, "flash_attention", flash)
    real = ops.packed_matmul

    def packed_matmul(x, p, impl="auto"):
        if p.bits != 8 and impl == "auto":
            cuda.LAUNCHES["quant_matmul"] += 1
        return real(x, p, impl)
    monkeypatch.setattr(ops, "packed_matmul", packed_matmul)
    monkeypatch.setattr(ServeEngine, "decode_params", lambda self:
                        self.params)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: _Card)
    monkeypatch.setattr(chip_smoke, "device_breakdown", lambda fn, top=20: (
        fn(), {"wall_ms": 1.0, "device_ms": 0.5, "idle_share": 0.5,
               "dtoh_copies": 0, "device_ops": 1, "qmm_gemv_ms": 0.0,
               "decode_attention_ms": 0.0, "lsq_fakequant_ms": 0.0,
               "lsq_fakequant_bwd_ms": 0.0, "copy_kernel_ms": 0.0,
               "copy_kernels": 0, "top": []})[1])
    monkeypatch.setattr(chip_smoke, "make_prompts", _short_prompts)
    return chip_smoke


BF16 = {"param_dtype": torch.bfloat16, "compute_dtype": torch.bfloat16}


def test_chip_smoke_zoo_phase_runs_on_cpu(cpu_card):
    """granite-20b's zoo phase at smoke size in bf16, as on the card (MQA,
    GeLU, LayerNorm, an untied head): Z1-Z4 hold; a decode step launches 6
    quant_matmul and 4 lsq_fakequant a layer, one more for the head, and
    one decode attention a layer, on each run's layout; the check reads 0
    over the prefill and 8 decode steps."""
    cfg = get_config("granite-20b").smoke().replace(**BF16)
    rec = cpu_card.phase_zoo(cfg, torch.device("cpu"), "cpu rehearsal")
    layers = cfg.n_repeats
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    assert set(rec["serve"]) == {"contiguous-int8", "contiguous-int4",
                                 "paged-int4"}
    for name, run in rec["serve"].items():
        step = run["launches_per_decode_step"]
        attention = ("paged_kv_decode_attention" if name.startswith("paged")
                     else "kv_decode_attention")
        assert (step["quant_matmul"], step["lsq_fakequant"],
                step[attention]) == (6 * layers, 4 * layers + 1, layers)
        assert run["new_tokens"] == cpu_card.ZOO_NEW
    assert rec["serve"]["paged-int4"]["tokens"] == \
        rec["serve"]["contiguous-int4"]["tokens"]
    check = rec["check"][8]
    assert len(check["rel_logit_err"]) == cpu_card.ZOO_CHECK_DECODE + 1
    assert max(check["rel_logit_err"]) == 0.0
    assert rec["peak_bytes"] == 0 and rec["packed_weight_bytes"] > 0


def test_chip_smoke_hubert_phase_runs_on_cpu(cpu_card, monkeypatch):
    """hubert-xlarge's phase at smoke size in bf16, as on the card (2 x 100
    frames: a ragged last chunk of the plain attention, not causal): the
    engine refuses it, EAGL takes impl="ref"'s take, and the packed
    forward launches 6 quant_matmul, 4 lsq_fakequant and 1 bf16
    flash_attention a layer and one more lsq_fakequant for the head, with
    finite (2, 100, 512) logits."""
    monkeypatch.setattr(cpu_card, "HUBERT_B", 2)
    monkeypatch.setattr(cpu_card, "HUBERT_S", 100)
    cfg = get_config("hubert-xlarge").smoke().replace(**BF16)
    rec = cpu_card.phase_hubert(cfg, torch.device("cpu"), "cpu rehearsal")
    fwd, layers = rec["forward"], cfg.n_repeats
    assert "autoregressive" in rec["refused"]
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    assert fwd["inputs"] == "embeds" and fwd["finite"]
    assert fwd["shape"] == [2, 100, cfg.vocab]
    assert {k: v for k, v in fwd["launches"].items() if v} == {
        "quant_matmul": 6 * layers, "lsq_fakequant": 4 * layers + 1,
        "flash_attention": layers}
    assert fwd["rel_logit_err"] == 0.0


def test_chip_smoke_dbrx_phase_runs_on_cpu(cpu_card):
    """dbrx-132b's phase at smoke size in bf16, as on the card (4 experts,
    top-2, LayerNorm): Z1-Z4 hold; EAGL makes one histogram launch a
    tensor (4 + 3 E a layer); a decode step and a prefill launch 4 + 3 E
    quant_matmul and 3 + 2 E lsq_fakequant a layer, one more for the head,
    and one attention a layer, as ``step_launches`` works out (208, 141
    and 4 at the card's 4 layers of 16 experts); the check reads 0 over
    the prefill and 8 decode steps; the schedule's paged full run over the
    first SCHED_DEPTH layers holds gates A, B and D, its decode steps drop
    no slot, and every admission's and aligned hit's dropped slots are
    counted."""
    full = get_config("dbrx-132b").replace(n_repeats=cpu_card.DBRX_DEPTH)
    assert cpu_card.step_launches(full) == {
        "quant_matmul": 208, "lsq_fakequant": 141, "attention": 4}
    cfg = get_config("dbrx-132b").smoke().replace(**BF16)
    rec = cpu_card.phase_zoo(cfg, torch.device("cpu"), "cpu rehearsal")
    e, layers = cfg.n_experts, cfg.n_repeats
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    assert rec["select"]["launches"]["histogram"] == (4 + 3 * e) * layers
    assert set(rec["raw_bytes_of"]) == {"embed", "head", "attn", "moe",
                                        "norms"}
    assert sum(rec["raw_bytes_of"].values()) == rec["raw_weight_bytes"]
    for name, run in rec["serve"].items():
        attention = ("paged_kv_decode_attention" if name.startswith("paged")
                     else "kv_decode_attention")
        for launches in (run["launches_per_decode_step"],
                         run["launches_per_prefill"]):
            assert (launches["quant_matmul"], launches["lsq_fakequant"]) == (
                (4 + 3 * e) * layers, (3 + 2 * e) * layers + 1)
        assert run["launches_per_decode_step"][attention] == layers
        assert run["dtoh_copies_8_steps"] == 0
    assert rec["serve"]["paged-int4"]["tokens"] == \
        rec["serve"]["contiguous-int4"]["tokens"]
    check = rec["check"][8]
    assert len(check["rel_logit_err"]) == cpu_card.ZOO_CHECK_DECODE + 1
    assert max(check["rel_logit_err"]) == 0.0
    assert rec["peak_bytes"] == 0 and rec["packed_weight_bytes"] > 0
    run = rec["schedule"]["paged-full"]
    assert run["gate_a"]["matched"] >= cpu_card.GATE_A_MIN
    assert not run["gate_a"]["differs"]
    assert run["gate_a"]["decode_dropped_slots"] == [0, 0]
    assert set(run["gate_a"]["dropped_slots"]) == set(run["plans"])
    assert run["registry_hits"] >= cpu_card.MIN_HITS
    assert set(run["gate_b_aligned"]["dropped_slots"]) == set(
        run["gate_b_aligned"]["gap"])


def test_chip_smoke_qwen_phase_runs_on_cpu(cpu_card, monkeypatch):
    """qwen2-vl-7b's phase at smoke size in bf16, as on the card (M-RoPE,
    GQA 4/1 here): Z1-Z4 over text; Z5's image-and-text prefill (2 x 64, a
    4 x 4 image) launches L flash_attention and ``step_launches``'
    matmuls and fake-quants, reads 0 against the plain path and moves off
    the text streams' logits; the schedule's paged full run over the
    first SCHED_DEPTH layers holds gates A, B and D with suffix prefills
    at shifted streams (196, 113 and 28 launches a step at the card's 28
    layers).  (With the card's vocabulary of 152064 the schedule draws
    the same lengths and budgets: 446 tokens, 2 deferrals, 13 hits, a
    peak of 139 pages against 154 without sharing; it takes 2.5 minutes
    here, so the test keeps the smoke vocabulary.)"""
    full = get_config("qwen2-vl-7b")
    assert cpu_card.step_launches(full) == {
        "quant_matmul": 196, "lsq_fakequant": 113, "attention": 28}
    monkeypatch.setattr(cpu_card, "MROPE_B", 2)
    monkeypatch.setattr(cpu_card, "MROPE_S", 64)
    monkeypatch.setattr(cpu_card, "MROPE_GRID", (1, 4, 4))
    cfg = get_config("qwen2-vl-7b").smoke().replace(**BF16)
    rec = cpu_card.phase_zoo(cfg, torch.device("cpu"), "cpu rehearsal")
    layers = cfg.n_repeats
    assert rec["select"]["take_equal"] and rec["select"]["n2"]
    for name, run in rec["serve"].items():
        attention = ("paged_kv_decode_attention" if name.startswith("paged")
                     else "kv_decode_attention")
        assert (run["launches_per_decode_step"]["quant_matmul"],
                run["launches_per_decode_step"]["lsq_fakequant"],
                run["launches_per_decode_step"][attention]) == (
                    7 * layers, 4 * layers + 1, layers)
        assert run["dtoh_copies_8_steps"] == 0
    assert rec["serve"]["paged-int4"]["tokens"] == \
        rec["serve"]["contiguous-int4"]["tokens"]
    assert max(rec["check"][8]["rel_logit_err"]) == 0.0
    z5 = rec["mrope"]
    assert z5["finite"] and z5["rel_logit_err"] == 0.0
    assert z5["text_streams_rel_logit_diff"] > 1e-3
    assert z5["launches"] == {"quant_matmul": 7 * layers,
                              "lsq_fakequant": 4 * layers + 1,
                              "flash_attention": layers}
    sched = rec["schedule"]
    assert set(sched) == {"paged-full"}
    run = sched["paged-full"]
    assert run["gate_a"]["matched"] >= cpu_card.GATE_A_MIN
    assert run["registry_hits"] >= cpu_card.MIN_HITS
    assert run["suffix_prefill"]["prefix"] > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_op_trace_finds_the_differing_op(cpu_card, monkeypatch, layout):
    """``chip_smoke.first_difference`` and ``op_trace`` (gate B's control,
    ROADMAP Queue 3 entry 9) on olmo-1b's smoke config, full cache,
    contiguous and as the schedule's paged full engine (``SCHED_RUNS``),
    with the flash stand-in moved on one row of the first block's
    attention: the first difference is that block and row, and the trace
    lists the block's ops in the same order on both paths, nothing
    differing before the attention, the attention differing on that row
    alone, and the next fake-quant's codes of that row a whole number of
    steps apart (up to bf16's rounding)."""
    from repro_torch.configs import olmo_1b
    from repro_torch.kernels import cuda
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec, ServeEngine, pack_params
    cfg = olmo_1b.config().smoke().replace(**BF16)
    dev = torch.device("cpu")
    raw = tf.init_params(cfg, seed=0, device=dev)
    pa = tf.build_policy(cfg).as_arrays()
    spec = (EngineSpec() if layout == "contiguous" else EngineSpec(
        page_size=cpu_card.PAGE, decode_chunk=16,
        n_pages=cpu_card.SCHED_POOL, **cpu_card.SCHED_RUNS["paged-full"][0]))
    engine = ServeEngine(cfg, pack_params(raw, pa, cfg, device=dev), pa,
                         64, spec, device=dev)
    row, calls, stand_in = 5, [0], cuda.flash_attention

    def moved(q, k, v, causal=True):
        out = stand_in(q, k, v, causal)
        calls[0] += 1
        if calls[0] % cfg.n_repeats == 1:     # the first block's
            out = out.clone()
            out[0, :, row] += 1.0
        return out
    monkeypatch.setattr(cuda, "flash_attention", moved)
    n = 20
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 32)))
    first = cpu_card.first_difference(engine, toks, n)
    assert (first["first"]["block"], first["first"]["row"]) == (0, row)
    trace = cpu_card.op_trace(engine, toks, n, 0, row)
    ops = [op["op"] for op in trace]
    at = ops.index("attention")
    assert ops[:at] == ["lsq_fakequant"] * 3 + ["matmul"] * 3
    assert all(op["rows_differing"] == 0 for op in trace[:at])
    assert trace[at]["first_rows"] == [row]
    assert trace[at]["row_max_abs_diff"] > 0.5
    after = trace[at + 1]
    assert after["op"] == "lsq_fakequant" and after["first_rows"] == [row]
    # whole steps, up to bf16's rounding of code x step (2^-8 relative)
    steps = after["row_max_diff_in_steps"]
    assert after["row_codes_differing"] > 0 and round(steps) >= 1
    assert abs(steps - round(steps)) <= 2 ** -8 * round(steps)
