"""The SSD scan's backward on the CPU: K3b's plain version
(``kernels/ssd_scan/ref.py::ssd_scan_bwd_ref``) against ``jax.vjp`` of the
JAX package's chunked scan (``repro.models.ssm.ssd_chunked``) and of its
sequential oracle (``repro.kernels.ssd_scan.ref.ssd_ref``), in f32, on the
same inputs from numpy's seeded generator; and ``ssd_scan`` under grad,
which on a CPU tensor runs the same ``torch.autograd.Function`` as on the
card, with each of its three operators' plain versions.  K3b itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (bwd_kernel_error,
                                              ssd_scan_bwd_ref, ssd_scan_ref,
                                              ssd_scan_states_ref)

# each gradient against JAX's within 2e-3 of its largest magnitude: the two
# packages round the decays (exp of cumulative sums of up to a few hundred)
# a few ulps apart, and a gradient's terms are up to a few hundred times
# its elements (ROADMAP, Queue 3)
JAX_REL = 2e-3
# the Function's gradients against autograd over ssd_scan_ref in the same
# package: the same f32 products summed in another order, to 1e-5 of each
# gradient's largest magnitude; da, one sum over every token of terms of
# both signs, to 3e-5 (autograd's own f32 da is 1.3e-5 of it from a double
# computation's on "one_chunk_dfinal", the plain backward's 0.6e-5)
SAME_REL = {"da": 3e-5}
NAMES = ("dx", "ddt", "da", "dB", "dC", "dinitial")
# b, s, h, p, g, n, chunk, initial state, dfinal
CASES = {
    "one_group": (2, 128, 4, 16, 1, 16, 32, False, False),
    "two_groups_init_dfinal": (1, 192, 6, 8, 2, 8, 64, True, True),
    "one_chunk_dfinal": (2, 32, 2, 16, 1, 8, 32, False, True),
    "init_only": (1, 96, 4, 8, 2, 16, 32, True, False),
}


def _inputs(seed, b, s, h, p, g, n, init, dfin):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bi = rng.standard_normal((b, s, g, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32) if init
          else None)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfinal = (rng.standard_normal((b, h, p, n)).astype(np.float32) if dfin
              else None)
    return x, dt, a, bi, ci, st, dy, dfinal


def _jax_grads(fn, x, dt, a, bi, ci, st, dy, dfinal):
    """``jax.vjp`` of ``fn(x, dt, a, B, C, initial_state) -> (y, final)``
    at (dy, dfinal or 0): the six gradients, the initial state's taken at
    zeros when there is none."""
    b, _, h, p = x.shape
    init = st if st is not None else np.zeros((b, h, p, bi.shape[3]),
                                              np.float32)
    (y, final), vjp = jax.vjp(fn, *map(jnp.asarray, (x, dt, a, bi, ci,
                                                     init)))
    cot = (jnp.asarray(dy), jnp.zeros_like(final) if dfinal is None
           else jnp.asarray(dfinal))
    return [np.asarray(g) for g in vjp(cot)]


def _assert_rel(got, want, rel, label):
    """Each gradient within ``rel`` (a number, or {name: number} with 1e-5
    for the others) of its largest magnitude."""
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, name)
        err = float(np.abs(g - w).max())
        tol = rel.get(name, 1e-5) if isinstance(rel, dict) else rel
        assert err <= tol * float(np.abs(w).max()), (label, name, err)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reference", ["ssd_chunked", "ssd_ref"])
def test_plain_backward_matches_jax_vjp(case, reference):
    b, s, h, p, g, n, chunk, init, dfin = CASES[case]
    x, dt, a, bi, ci, st, dy, dfinal = _inputs(7, b, s, h, p, g, n, init,
                                               dfin)
    if reference == "ssd_chunked":
        def fn(*args):
            return jax_ssm.ssd_chunked(*args[:5], chunk, args[5])
    else:
        def fn(*args):
            return jax_ssd_ref(*args)
    want = _jax_grads(fn, x, dt, a, bi, ci, st, dy, dfinal)
    got = ssd_scan_bwd_ref(*map(_t, (x, dt, a, bi, ci)), chunk, _t(st), None,
                           _t(dy), _t(dfinal))
    assert [t.dtype for t in got] == [torch.float32] * 6
    _assert_rel([t.numpy() for t in got], want, JAX_REL, (case, reference))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_scan_under_grad_goes_through_the_function(case):
    """On a CPU tensor ``ssd_scan`` under grad is the autograd Function
    over ``ssd_scan_states`` and ``ssd_scan_bwd`` (their plain versions):
    y, the final state and all six gradients equal autograd over
    ``ssd_scan_ref``."""
    b, s, h, p, g, n, chunk, init, dfin = CASES[case]
    arrays = _inputs(11, b, s, h, p, g, n, init, dfin)
    x, dt, a, bi, ci, st, dy, dfinal = map(_t, arrays)
    dfinal = torch.zeros(b, h, p, n) if dfinal is None else dfinal
    ins = [t for t in (x, dt, a, bi, ci, st) if t is not None]
    ours = [t.clone().requires_grad_(True) for t in ins]
    y, final = ssd_scan(*ours[:5], chunk=chunk,
                        initial_state=ours[5] if st is not None else None)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    got = torch.autograd.grad((y, final), ours, (dy, dfinal))
    theirs = [t.clone().requires_grad_(True) for t in ins]
    y2, final2 = ssd_scan_ref(*theirs[:5], chunk,
                              theirs[5] if st is not None else None)
    want = torch.autograd.grad((y2, final2), theirs, (dy, dfinal))
    for u, v in ((y, y2), (final, final2)):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    _assert_rel([t.numpy() for t in got], [t.numpy() for t in want],
                SAME_REL, case)


def test_the_trace_records_the_states_and_backward_operators():
    """A trace of a loss's gradient through ``ssd_scan`` records one node
    of ``ssd_scan_states`` and one of ``ssd_scan_bwd`` (the export writes
    each as a ``call``); without a gradient, one ``ssd_scan``."""
    b, s, h, p, g, n, chunk, init, dfin = CASES["two_groups_init_dfinal"]
    x, dt, a, bi, ci, st, _, _ = map(_t, _inputs(3, b, s, h, p, g, n, init,
                                                 dfin))

    def step(x, dt, a, bi, ci, st):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, dt, a, bi, ci, st)]
        y, final = ssd_scan(*leaves[:5], chunk=chunk,
                            initial_state=leaves[5])
        return torch.autograd.grad(y.square().sum() + final.sum(), leaves)

    def names(graph):
        return sorted(str(node.target) for node in graph.graph.nodes
                      if "repro_torch" in str(node.target))

    graph = make_fx(step, tracing_mode="fake")(x, dt, a, bi, ci, st)
    assert names(graph) == ["repro_torch.ssd_scan_bwd.default",
                            "repro_torch.ssd_scan_states.default"]
    with torch.no_grad():
        graph = make_fx(lambda *t: ssd_scan(*t[:5], chunk=chunk,
                                            initial_state=t[5]),
                        tracing_mode="fake")(x, dt, a, bi, ci, st)
    assert names(graph) == ["repro_torch.ssd_scan.default"]


def test_the_states_are_the_inbound_states_of_each_chunk():
    """``ssd_scan_states_ref`` returns ssd_scan_ref's y and final state and
    each chunk's inbound state: the initial state first, the state after
    chunk c at c + 1, as the sequential oracle has them."""
    b, s, h, p, g, n, chunk, init, dfin = CASES["init_only"]
    x, dt, a, bi, ci, st, _, _ = map(_t, _inputs(5, b, s, h, p, g, n, init,
                                                 dfin))
    y, final, states = ssd_scan_states_ref(x, dt, a, bi, ci, chunk, st)
    y0, final0 = ssd_scan_ref(x, dt, a, bi, ci, chunk, st)
    assert torch.equal(y, y0) and torch.equal(final, final0)
    assert states.shape == (b, s // chunk, h, p, n)
    torch.testing.assert_close(states[:, 0], st, rtol=0, atol=0)
    for c in range(1, s // chunk):
        _, after = ssd_scan_ref(x[:, :c * chunk], dt[:, :c * chunk], a,
                                bi[:, :c * chunk], ci[:, :c * chunk], chunk,
                                st)
        torch.testing.assert_close(states[:, c], after, rtol=1e-5,
                                   atol=1e-5 * float(after.abs().max()))


@pytest.mark.parametrize("wrong", ["none", "state_term", "q_sign", "dB_sum"])
def test_the_kernels_check_passes_the_plain_version_and_not_a_wrong_one(
        wrong):
    """``bwd_kernel_error``, K3b's check on the card, on the plain version's
    own f32 gradients (every ratio at most 1) and on three wrong ones: the
    inbound state's term of dC left out, the sign of the q_j reaching dT
    flipped, dB summed over one head of the group only."""
    b, s, h, p, g, n, chunk, init, dfin = CASES["two_groups_init_dfinal"]
    x, dt, a, bi, ci, st, dy, dfinal = map(_t, _inputs(9, b, s, h, p, g, n,
                                                       init, dfin))
    args = (x, dt, a, bi, ci, chunk, st)
    grads = list(ssd_scan_bwd_ref(*args, None, dy, dfinal))
    if wrong == "state_term":
        # dC without exp(dacs_i) S^T dy_i: C's gradient from a zero state
        zero = torch.zeros_like(st)
        grads[4] = ssd_scan_bwd_ref(x, dt, a, bi, ci, chunk, zero, None, dy,
                                    dfinal)[4]
    elif wrong == "q_sign":
        # ddt and da as if the final state's gradient entered with - sign
        flipped = ssd_scan_bwd_ref(*args, None, dy, -dfinal)
        grads[1], grads[2] = flipped[1], flipped[2]
    elif wrong == "dB_sum":
        one = ssd_scan_bwd_ref(x[:, :, ::h // g], dt[:, :, ::h // g],
                               a[::h // g], bi, ci, chunk,
                               st[:, ::h // g], None, dy[:, :, ::h // g],
                               dfinal[:, ::h // g])
        grads[3] = one[3]
    errs = bwd_kernel_error(grads, x, dt, a, bi, ci, chunk, st, dy, dfinal)
    worst = max(max(e[1], e[2]) for e in errs)
    if wrong == "none":
        assert worst <= 1.0, errs
    else:
        assert worst > 10.0, (wrong, errs)


def test_the_backward_operator_runs_its_plain_version_on_the_cpu():
    """``repro_torch::ssd_scan_bwd`` on CPU tensors is the plain version,
    the states argument unread."""
    b, s, h, p, g, n, chunk, init, dfin = CASES["init_only"]
    x, dt, a, bi, ci, st, dy, _ = map(_t, _inputs(2, b, s, h, p, g, n, init,
                                                  dfin))
    got = ops._BWD(x, dt, a, bi, ci, chunk, st,
                   torch.zeros(b, s // chunk, h, p, n), dy, None)
    want = ssd_scan_bwd_ref(x, dt, a, bi, ci, chunk, st, None, dy, None)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_the_card_raises_rather_than_fall_back():
    """The kernels' wrappers take only CUDA tensors: a CPU tensor handed to
    K3b's launch raises instead of computing anything."""
    b, s, h, p, g, n, chunk, init, dfin = CASES["one_group"]
    x, dt, a, bi, ci, _, dy, _ = map(_t, _inputs(1, b, s, h, p, g, n, init,
                                                 dfin))
    states = torch.zeros(b, s // chunk, h, p, n)
    with pytest.raises(ValueError, match="tensors on"):
        ops.ssd_scan_bwd(x, dt, a, bi, ci, states, dy, chunk=chunk)
