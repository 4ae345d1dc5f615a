"""The port's DDIM, DPM-Solver++ and LCM schedulers against ``gmdx.schedulers``
and the committed torch-oracle goldens, on the CPU.

Each trajectory runs a fake model (``0.3 x + sin(0.01 t) base_eps``) on
seeded 1x4x8x8 inputs through both packages; the stochastic steps take
``noise=`` drawn in the test as ``jax.random.normal(key, shape)`` from per-step
JAX keys, so both sides see one draw. Every step must agree to 1e-5 of the
trajectory's peak; the goldens hold to the JAX suite's 5e-4.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gmdx.schedulers as J
from gmdx_torch.schedulers import (
    SCHEDULERS,
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
    LCMScheduler,
    PNDMScheduler,
    SchedulerConfig,
    get_scheduler,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens", "schedulers")
SHAPE = (1, 4, 8, 8)
REL_TOL = 1e-5
GOLDEN_TOL = 5e-4  # tests/test_scheduler_goldens.py:22


def _fake_eps(x: np.ndarray, t: int, base_eps: np.ndarray) -> np.ndarray:
    return (0.3 * x + np.float32(np.sin(t * 0.01)) * base_eps).astype(np.float32)


def _trajectories(ours, theirs, steps, *, j_state, eta=None, stochastic=False, seed=0):
    """Run both schedulers from one seeded start; returns the two stacks."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    base_eps = rng.standard_normal(SHAPE).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), steps)
    s_ours = ours.init_state(steps)
    x_o, x_j = torch.from_numpy(x0), jnp.asarray(x0)
    traj_o, traj_j = [], []
    for i in range(steps):
        t = s_ours.timestep
        assert t == int(j_state.timestep), (i, t, int(j_state.timestep))
        kw_o, kw_j = {}, {}
        if eta is not None:
            kw_o["eta"] = kw_j["eta"] = eta
        if stochastic:
            noise = jax.random.normal(keys[i], SHAPE, jnp.float32)
            kw_o["noise"] = torch.from_numpy(np.array(noise))
            kw_j["key"] = keys[i]
        x_o = ours.step(s_ours, torch.from_numpy(_fake_eps(x_o.numpy(), t, base_eps)), x_o,
                        **kw_o)
        j_state, x_j = theirs.step(j_state, jnp.asarray(_fake_eps(np.asarray(x_j), t, base_eps)),
                                   x_j, **kw_j)
        traj_o.append(x_o.numpy())
        traj_j.append(np.asarray(x_j))
    return np.stack(traj_o), np.stack(traj_j)


def _assert_close(traj_o, traj_j):
    assert np.isfinite(traj_o).all()
    peak = np.abs(traj_j).max()
    err = np.abs(traj_o - traj_j).max(axis=tuple(range(1, traj_o.ndim)))
    assert err.max() <= REL_TOL * peak, f"step {int(err.argmax())}: {err.max()} of peak {peak}"


@pytest.mark.parametrize("eta", [0.0, 0.7])
@pytest.mark.parametrize("steps", [10, 50])
def test_ddim_matches_jax(eta, steps):
    theirs = J.DDIMScheduler()
    _assert_close(*_trajectories(DDIMScheduler(), theirs, steps, eta=eta,
                                 j_state=theirs.init_state(steps), stochastic=eta > 0))


@pytest.mark.parametrize("config", [
    dict(clip_sample=True, clip_sample_range=0.5),
    dict(prediction_type="v_prediction", set_alpha_to_one=True),
    dict(prediction_type="sample"),
], ids=["clip", "v_pred", "sample"])
def test_ddim_config_branches_match_jax(config):
    theirs = J.DDIMScheduler(**config)
    _assert_close(*_trajectories(DDIMScheduler(SchedulerConfig(**config)), theirs, 20, eta=0.3,
                                 j_state=theirs.init_state(20), stochastic=True, seed=3))


_DPM_CASES = {
    "order2_8": (8, {}),
    "order2_20": (20, {}),
    "order2_75": (75, {}),
    "karras_20": (20, dict(use_karras_sigmas=True)),
    "karras_8": (8, dict(use_karras_sigmas=True)),
    "sigma_min_20": (20, dict(final_sigmas_type="sigma_min")),
    "sigma_min_8": (8, dict(final_sigmas_type="sigma_min")),
    "order1_20": (20, dict(solver_order=1)),
    "no_lower_final_8": (8, dict(lower_order_final=False)),
    "v_pred_20": (20, dict(prediction_type="v_prediction")),
}


@pytest.mark.parametrize("case", sorted(_DPM_CASES))
def test_dpm_matches_jax(case):
    steps, kw = _DPM_CASES[case]
    theirs = J.DPMSolverMultistepScheduler(**kw)
    ours = get_scheduler("dpm++", **kw)
    assert ours.timesteps(steps) == [int(t) for t in np.asarray(theirs.timesteps(steps))]
    _assert_close(*_trajectories(ours, theirs, steps, j_state=theirs.init_state(steps, SHAPE),
                                 seed=1))


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_lcm_matches_jax(steps):
    theirs = J.LCMScheduler()
    ours = LCMScheduler()
    assert ours.timesteps(steps) == [int(t) for t in np.asarray(theirs.timesteps(steps))]
    _assert_close(*_trajectories(ours, theirs, steps, j_state=theirs.init_state(steps),
                                 stochastic=True, seed=2))


@pytest.mark.parametrize("steps", [7, 13, 49, 50, 100])
def test_timestep_grids_match_jax(steps):
    assert DDIMScheduler().init_state(steps).timesteps == [
        int(t) for t in np.asarray(J.DDIMScheduler().init_state(steps).timesteps)]
    for kw in ({}, dict(use_karras_sigmas=True)):
        ours = DPMSolverMultistepScheduler(use_karras_sigmas=bool(kw))
        assert ours.timesteps(steps) == [
            int(t) for t in np.asarray(J.DPMSolverMultistepScheduler(**kw).timesteps(steps))]
    if steps <= 50:
        assert LCMScheduler().timesteps(steps) == [
            int(t) for t in np.asarray(J.LCMScheduler().timesteps(steps))]


def _golden_cases():
    names = ("ddim_50_eta0", "ddim_50_eta07", "dpm_20", "dpm_75")
    return [os.path.join(GOLDEN_DIR, f"{n}.npz") for n in names]


@pytest.mark.parametrize("path", _golden_cases(), ids=os.path.basename)
def test_matches_golden(path):
    """The committed torch-oracle trajectories the JAX schedulers are held
    to (tests/test_scheduler_goldens.py), with its fake model and tolerance."""
    data = np.load(path)
    name = os.path.basename(path)
    steps = int(data["steps"])
    sched = DDIMScheduler() if name.startswith("ddim") else DPMSolverMultistepScheduler()
    state = sched.init_state(steps)
    kw = {}
    if "eta" in data:
        kw["eta"] = float(data["eta"])
    x = torch.from_numpy(data["x0"])
    assert data["traj"].shape[0] == steps
    for i in range(steps):
        t = state.timestep
        eps = torch.from_numpy(_fake_eps(x.numpy(), t, data["base_eps"]))
        if "noise" in data:
            kw["noise"] = torch.from_numpy(data["noise"][i])
        x = sched.step(state, eps, x, **kw)
        err = float(np.abs(x.numpy() - data["traj"][i]).max())
        assert err < GOLDEN_TOL, f"{name} step {i} (t={t}): maxabs {err}"


def test_errors_match_jax():
    x = torch.zeros(SHAPE)
    ddim = DDIMScheduler()
    with pytest.raises(ValueError, match="eta > 0 needs a generator"):
        ddim.step(ddim.init_state(10), x, x, eta=0.5)
    ddim.step(ddim.init_state(10), x, x, eta=0.0)  # eta 0 needs no randomness
    with pytest.raises(ValueError, match="original_inference_steps"):
        LCMScheduler().init_state(51)
    with pytest.raises(ValueError, match="original_inference_steps"):
        J.LCMScheduler().init_state(51)
    lcm = LCMScheduler()
    with pytest.raises(ValueError, match="needs a generator"):
        lcm.step(lcm.init_state(4), x, x)
    for kw, exc in ((dict(solver_order=3), NotImplementedError),
                    (dict(algorithm_type="dpmsolver"), NotImplementedError),
                    (dict(thresholding=True), NotImplementedError),
                    (dict(final_sigmas_type="karras"), ValueError)):
        with pytest.raises(exc):
            J.DPMSolverMultistepScheduler(**kw)
        with pytest.raises(exc):
            get_scheduler("dpmsolver++", **kw)
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("euler")


def test_get_scheduler_names_match_jax():
    assert sorted(SCHEDULERS) == sorted(J.SCHEDULERS)
    for name in SCHEDULERS:
        ours, theirs = get_scheduler(name), J.get_scheduler(name)
        assert type(ours).__name__ == type(theirs).__name__
        np.testing.assert_allclose(ours.alphas_cumprod, np.asarray(theirs.alphas_cumprod),
                                   rtol=1e-5)
    assert get_scheduler("dpm++").config.timestep_spacing == "linspace"
    assert isinstance(get_scheduler("ddpm", beta_schedule="linear"), DDPMScheduler)
    assert isinstance(get_scheduler("PNDM", steps_offset=0), PNDMScheduler)


def test_stochastic_steps_draw_from_generator():
    """A generator's draw equals passing that draw as ``noise=``, and DDIM
    at eta 0 does not consume the generator."""
    rng = np.random.default_rng(5)
    x, eps = (torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)) for _ in range(2))
    for sched, kw in ((DDIMScheduler(), dict(eta=0.5)), (LCMScheduler(), {})):
        g = torch.Generator().manual_seed(7)
        a = sched.step(sched.init_state(4), eps, x, generator=g, **kw)
        noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(7))
        b = sched.step(sched.init_state(4), eps, x, noise=noise, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator().manual_seed(7)
    ddim = DDIMScheduler()
    ddim.step(ddim.init_state(4), eps, x, eta=0.0, generator=g)
    assert torch.equal(torch.randn(3, generator=g),
                       torch.randn(3, generator=torch.Generator().manual_seed(7)))
