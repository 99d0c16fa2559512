"""Distillation (``repro_torch.optim.distill.make_distill_loss``) over
every input kind of the zoo: frame embeddings (hubert-xlarge, no token
table) and M-RoPE's (3, B, S) position streams (qwen2-vl-7b), on each
``.smoke()`` config in float32 on the CPU, against the reference's loss.

The reference's ``make_distill_loss`` hands the student's and the
teacher's forwards the whole batch.  Its module cannot be imported here
(its dead-code check lists it as unused, ``test_torch_selection.py``
says why), so the reference side is ``test_torch_selection``'s JAX copy
of its ten lines.

Tolerance: the distilled loss and its KD term within 1e-5 relative of the
reference's on the same params and batch (summation order;
``test_torch_train.py``'s loss bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.parallel.context import local_context  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.distill import make_distill_loss  # noqa: E402
from test_torch_mrope import vl_streams  # noqa: E402
from test_torch_selection import _jax_distill_loss  # noqa: E402
from test_torch_zoo import _make  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, b=2, s=32):
    """Labels, and the model's inputs: frame embeddings for an
    ``embed_input`` model, else tokens, with distinct M-RoPE streams for
    an M-RoPE model."""
    rng = np.random.default_rng(11)
    batch = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.embed_input:
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.rope == "mrope":
        batch["mrope_positions"] = vl_streams(b, s, seed=2)
    return batch


@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-vl-7b"])
def test_distilled_loss_matches_jax(name):
    """The 4/2 mix's distilled loss (alpha 0.5, T = 2) on raw params."""
    s = _make(name)
    ja, ta = s["arrays"]["mixed"]
    batch = _batch(s["cfg"])
    want, wm = jax.jit(lambda p, pa, b: _jax_distill_loss()(
        p, pa, b, s["jcfg"], local_context()))(
            s["jparams"], jax.tree.map(jnp.asarray, ja),
            jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got, gm = make_distill_loss(ttf.loss_fn, ttf.apply)(
            s["tparams"], ta, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, s["cfg"])
    assert float(wm["kd_loss"]) > 0
    for a, b in ((got, want), (gm["kd_loss"], wm["kd_loss"])):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (a, b)
