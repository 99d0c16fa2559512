"""Port policy and knapsack against the JAX package: same units, same
policy arrays, same knapsack ``take`` set on the olmo smoke policy."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs  # noqa: E402
from repro.core import knapsack as jk  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.core import knapsack as tk  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402


@pytest.fixture(scope="module")
def policies():
    return (jtf.build_policy(configs.get_config("olmo-1b").smoke()),
            ttf.build_policy(olmo_1b.config().smoke()))


def test_units_match(policies):
    jp, tp = policies
    for ju, tu in zip(jp.units, tp.units, strict=True):
        assert (ju.name, ju.group, ju.layer, ju.slot, ju.n_params,
                ju.macs_per_token, ju.in_features, ju.pinned_bits) == \
            (tu.name, tu.group, tu.layer, tu.slot, tu.n_params,
             tu.macs_per_token, tu.in_features, tu.pinned_bits)
        assert tuple(ju.tensors) == tuple(tu.tensors)
    assert [c.name for c in jp.cache_units] == [c.name for c in tp.cache_units]
    assert tk.synthetic_gains(tp) == jk.synthetic_gains(jp)


@pytest.mark.parametrize("budget", [0.7, 0.6])
def test_select_for_budget_same_take(policies, budget):
    jp, tp = policies
    jr = jk.select_for_budget(jp, jk.synthetic_gains(jp), budget_frac=budget)
    tr = tk.select_for_budget(tp, tk.synthetic_gains(tp), budget_frac=budget)
    assert tr.take == jr.take
    assert (tr.total_value, tr.total_weight) == (jr.total_value,
                                                 jr.total_weight)
    ja = jp.apply_selection(jr.take).as_arrays()
    ta = tp.apply_selection(tr.take).as_arrays()
    assert ja.keys() == ta.keys()
    for g in ja:
        for slot in ja[g]:
            np.testing.assert_array_equal(ta[g][slot], ja[g][slot])
    bits = [tp.apply_selection(tr.take).bits_of(u.name)
            for u in tp.selectable_units()]
    assert 2.0 in bits and 4.0 in bits          # a genuine 4/2 mix


def test_full_size_policy_selects_a_mix():
    """olmo-1b at full width: 64 selectable units, a 4/2 mix at 0.7."""
    tp = ttf.build_policy(olmo_1b.config())
    assert len(tp.selectable_units()) == 64
    res = tk.select_for_budget(tp, tk.synthetic_gains(tp), budget_frac=0.7)
    jp = jtf.build_policy(configs.get_config("olmo-1b"))
    assert res.take == jk.select_for_budget(jp, jk.synthetic_gains(jp),
                                            budget_frac=0.7).take
    assert 0 < sum(res.take.values()) < len(res.take)


def test_solve_edge_cases():
    assert tk.solve([], [], [], 1.0).take == {}
    assert tk.solve(["a", "b"], [1.0, 2.0], [1.0, 1.0], 5.0).take == \
        {"a": True, "b": True}
    assert tk.solve(["a", "b"], [1.0, 2.0], [0.0, 1.0], 0.0).take == \
        {"a": True, "b": False}
    with pytest.raises(ValueError):
        tk.solve(["a"], [1.0], [-1.0], 1.0)
