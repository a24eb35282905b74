"""repro_torch's Mamba2 block (``models/ssm.py``) against repro's on the
same inputs (numpy from a seed) and the same weights (one layer of the
reduced mamba2-130m, converted with from_jax_params), fp32 on the CPU:
the causal conv, the segment sum, the chunked SSD scan with and without
an initial state, the block over right-padded prompts and the one-token
decode.

Tolerances: the conv and the segment sum are elementwise in the same
order in both packages, held at 1e-6; the scan, the block and the
decode go through einsums whose contraction order may differ, held at
1e-4 (absolute and relative), as ``test_torch_model.py``. ``exp`` of
the segment sum with -inf above the diagonal must give exact zeros in
both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.models import hybrid as thybrid
from repro_torch.models import ssm as tssm

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4
EXACT_TOL = 1e-6
# the reference under jit (eager JAX dispatches every op on its own)
J_APPLY = jax.jit(jssm.apply_mamba2,
                  static_argnames=("cfg", "return_state"))
J_DECODE = jax.jit(jssm.decode_mamba2, static_argnames=("cfg",))
J_SSD = jax.jit(jssm.ssd_chunked, static_argnames=("cfg",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def layer():
    """One Mamba2 layer of the reduced mamba2-130m (d_model 64, 8 heads
    of 16, d_state 16, chunk 16) in both packages."""
    jcfg = JCONFIGS["mamba2-130m"].reduced()
    jp = jax.jit(lambda k: jhybrid.init_hybrid(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    jl = jax.tree.map(lambda a: a[0], jp["mamba"]["mamba"])
    tl = from_jax_params(jax.tree.map(np.asarray, jl), "cpu")
    return (jhybrid._ssm_cfg(jcfg), thybrid.ssm_cfg(
        TCONFIGS["mamba2-130m"].reduced()), jl, tl)


def _ssd_inputs(cfg, b, l, seed):
    rng = np.random.default_rng(seed)
    h, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.6, size=(b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, l, 1, n)).astype(np.float32),
            rng.normal(size=(b, l, 1, n)).astype(np.float32))


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(history):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    hist = rng.normal(size=(2, 3, 12)).astype(np.float32) if history \
        else None
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if hist is None else jnp.asarray(hist))
    got = tssm._causal_conv(_t(x), _t(w), None if hist is None else _t(hist))
    _close(got, want, EXACT_TOL)


def test_segsum_matches_reference():
    dta = -np.random.default_rng(1).uniform(
        0.0, 1.0, size=(2, 3, 16)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(dta)))
    got = tssm._segsum(_t(dta)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()
    _close(torch.from_numpy(got), want, EXACT_TOL)
    assert (torch.exp(torch.from_numpy(got))[..., 0, 1] == 0).all()


@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_reference(layer, init_state):
    """40 tokens in chunks of 16: three chunks, the last padded by 8."""
    jcfg, tcfg, _, _ = layer
    x, dt, a, bm, cm = _ssd_inputs(tcfg, 2, 40, seed=2)
    s0 = None
    if init_state:
        s0 = np.random.default_rng(3).normal(size=(
            2, tcfg.n_heads, tcfg.head_dim, tcfg.d_state)).astype(np.float32)
    jy, js = J_SSD(*map(jnp.asarray, (x, dt, a, bm, cm)), jcfg,
                   init_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), tcfg,
                              init_state=None if s0 is None else _t(s0))
    assert ts.dtype == torch.float32 and ts.shape == js.shape
    _close(ty, jy)
    _close(ts, js)


def _x(cfg, b, l, seed):
    return (0.5 * np.random.default_rng(seed).normal(
        size=(b, l, cfg.d_model))).astype(np.float32)


def test_apply_mamba2_padded_matches_reference_and_unpadded(layer):
    """Right-padded prompts of 40, 7 and 23 tokens (prompt_len): the
    output and the final state and conv tails equal repro's, and each
    row's state and tails equal its unpadded run's."""
    jcfg, tcfg, jl, tl = layer
    x = _x(tcfg, 3, 40, seed=4)
    plen = np.array([40, 7, 23], np.int32)
    jy, jst = J_APPLY(jl, jnp.asarray(x), jcfg, return_state=True,
                      prompt_len=jnp.asarray(plen))
    ty, tst = tssm.apply_mamba2(tl, _t(x), tcfg, return_state=True,
                                prompt_len=_t(plen))
    _close(ty, jy)
    for t, j in zip(tst, jst):
        _close(t, j)
    for i, n in enumerate(plen):
        _, alone = tssm.apply_mamba2(tl, _t(x[i:i + 1, :n]), tcfg,
                                     return_state=True)
        for t, a in zip(tst, alone):
            _close(t[i:i + 1], a.numpy())


def test_apply_mamba2_continues_from_a_state(layer):
    """A prefill of 25 tokens continued by 15 more from its state, in
    both packages, equals repro's."""
    jcfg, tcfg, jl, tl = layer
    x = _x(tcfg, 2, 40, seed=5)
    _, jst = J_APPLY(jl, jnp.asarray(x[:, :25]), jcfg, return_state=True)
    _, tst = tssm.apply_mamba2(tl, _t(x[:, :25]), tcfg, return_state=True)
    jy, jst = J_APPLY(jl, jnp.asarray(x[:, 25:]), jcfg, state=jst,
                      return_state=True)
    ty, tst = tssm.apply_mamba2(tl, _t(x[:, 25:]), tcfg, state=tst,
                                return_state=True)
    _close(ty, jy)
    for t, j in zip(tst, jst):
        _close(t, j)


def test_decode_mamba2_matches_reference_in_place(layer):
    """Four one-token steps from a 30-token prefill's state: outputs
    and states equal repro's, and each step writes the state and rings
    into the tensors it was given."""
    jcfg, tcfg, jl, tl = layer
    x = _x(tcfg, 2, 34, seed=6)
    _, jst = J_APPLY(jl, jnp.asarray(x[:, :30]), jcfg, return_state=True)
    _, tst = tssm.apply_mamba2(tl, _t(x[:, :30]), tcfg, return_state=True)
    ptrs = [t.data_ptr() for t in tst]
    for j in range(30, 34):
        jy, jst = J_DECODE(jl, jnp.asarray(x[:, j:j + 1]), jcfg, jst)
        ty, out_st = tssm.decode_mamba2(tl, _t(x[:, j:j + 1]), tcfg, tst)
        assert [t.data_ptr() for t in out_st] == ptrs
        _close(ty, jy)
        for t, s in zip(tst, jst):
            _close(t, s)


def test_decode_continues_a_multi_chunk_prefill(layer):
    """The CPU counterpart of the card's multi-chunk check: a prefill of
    47 tokens (three chunks of 16) and one decode step give the output
    of a 48-token prefill at its last position."""
    _, tcfg, _, tl = layer
    x = _t(_x(tcfg, 2, 48, seed=7))
    full, _ = tssm.apply_mamba2(tl, x, tcfg)
    _, st = tssm.apply_mamba2(tl, x[:, :47], tcfg, return_state=True)
    step, _ = tssm.decode_mamba2(tl, x[:, 47:], tcfg, st)
    _close(step[:, 0], full[:, 47].numpy())
