"""Gate B's control on olmo-1b's schedule on the card (ROADMAP Queue 3
entry 9): request s6's whole-prompt prefill through the schedule's paged
full engine, each block on the kernel path against its plain version
(impl="ref") on the same input, then the first block that differs op by
op (``chip_smoke.op_trace``).

The first block differs from its plain version in one row of 282, by
0.146 of max|plain| (``chip_smoke.ONE_BLOCK_BOUND`` is 1e-3), and this test
holds the cause found on the card: every op before the attention equals
its plain version to the bit; flash's output is within one bf16 ulp of
the plain attention's (its P.V product takes bf16 probabilities); and
each row where the block differs is a row where the next fake-quant (the
4-bit input of the output projection) moved exactly one code by one step:
an input within a bf16 ulp of a rounding boundary.  A kernel that
computed a row wrongly fails the first two; a difference from anything
but that one code fails the last."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


@pytest.mark.cuda
def test_olmo_s6_first_block_differs_by_one_code():
    """olmo-1b at full width, its first SCHED_DEPTH layers, weights from
    seed 0, EAGL's mix at 0.7 over all 16 layers (``phase_select``), a
    fresh paged full engine of the schedule's spec; s6's prompt (282
    tokens, bucketed to 288) from ``schedule_requests``' seed 2."""
    from repro_torch.configs import olmo_1b
    from repro_torch.models import transformer as tf
    from repro_torch.serve import EngineSpec, ServeEngine, pack_params
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the block's kernel path runs the "
                    "hand-written kernels")
    dev = torch.device("cuda")
    cfg = olmo_1b.config()
    raw = tf.init_params(cfg, seed=0, device=dev)
    mixed, _ = chip_smoke.phase_select(cfg, raw, dev)
    pa = mixed.as_arrays()
    packed = pack_params(raw, pa, cfg, device=dev)
    del raw
    depth = chip_smoke.SCHED_DEPTH
    cut = cfg.replace(n_repeats=depth)
    spec, _, _ = chip_smoke.SCHED_RUNS["paged-full"]
    engine = ServeEngine(
        cut, dict(packed, pat=packed["pat"][:depth]), pa,
        chip_smoke.SCHED_MAX_SEQ,
        EngineSpec(page_size=chip_smoke.PAGE, decode_chunk=16,
                   n_pages=chip_smoke.SCHED_POOL, **spec), device=dev)
    prompt = {u: p for u, p, _ in chip_smoke.schedule_requests(
        cut, np.random.default_rng(2))}["s6"]
    assert len(prompt) == 282
    sched = chip_smoke.audited(engine)
    toks = sched._prompt_tokens(prompt, sched._bucket_pad(
        len(prompt), chip_smoke.SCHED_MAX_SEQ))
    first = chip_smoke.first_difference(engine, toks, len(prompt))
    if first["first"] is None:
        return                        # the kernel path is the plain one
    block, row = first["first"]["block"], first["first"]["row"]
    ops = chip_smoke.op_trace(engine, toks, len(prompt), block, row)
    names = [op.get("op") for op in ops]
    at = names.index("attention")
    assert all(op["rows_differing"] == 0 for op in ops[:at]), ops[:at]
    att = ops[at]
    ulp = 2.0 ** (math.floor(math.log2(att["max_abs_plain"])) - 7)
    assert att["max_abs_diff"] <= ulp, att
    flip = ops[at + 1]
    assert flip["op"] == "lsq_fakequant", flip
    assert flip["rows_differing"] == first["first"]["block_rows_differing"]
    assert row in flip["first_rows"] and flip["row_codes_differing"] == 1
    assert abs(flip["row_max_diff_in_steps"] - 1.0) <= 2.0 ** -7, flip
