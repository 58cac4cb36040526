"""Shared helpers of the tests that hold the PyTorch port
(``scalecube_cluster_tpu_torch``) against the JAX package.

Both sides get the same inputs: parameters and worlds cross over as
plain data (``interop``), and each round's randomness is rebuilt from the
JAX key with the reference's own ``jax.random`` calls and handed to the
port as a ``RoundDraws``.  Everything compared is an integer or a
compare of identical float32 draws against identical float32
probabilities, so every comparison is exact equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.ops import prng as jprng
from scalecube_cluster_tpu_torch import interop
from scalecube_cluster_tpu_torch.ops.prng import RoundDraws

STATE_FIELDS = ("status", "inc", "spread_until", "suspect_deadline",
                "self_inc")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests (the suite runs
    several xdist workers side by side), restored after the module so
    other test files in the worker keep the default."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def jax_draws(key, params):
    """``round_idx -> RoundDraws`` holding exactly the draws the reference
    tick consumes under ``key`` (models/swim.py: round keys :1908-1911,
    channel shifts :1920-1924 + :3609-3616, direct chain :1687 under
    k_ping_net, proxy chains :3562, drop draws :3770, refute drop
    :3894)."""
    n, r, f = params.n_members, params.ping_req_members, params.fanout

    @jax.jit
    def one(round_idx):
        keys = jax.random.split(
            jprng.round_key(jprng.round_key(key, round_idx), 0), 8)
        k_shifts = jax.random.fold_in(jprng.round_key(key, round_idx), 0x5317)
        shifts = jax.random.randint(k_shifts, (1 + r + f + 1,), 1, n,
                                    dtype=jnp.int32)
        u_proxy = jnp.stack(
            [jax.random.uniform(jax.random.fold_in(keys[3], i), (n,))
             for i in range(r)]) if r else jnp.zeros((0, n), jnp.float32)
        return (shifts, jax.random.uniform(keys[1], (n,)), u_proxy,
                jax.random.uniform(keys[5], (n, f + 1)),
                jax.random.uniform(keys[7], (n,)))

    def draws(round_idx):
        shifts, u_direct, u_proxy, drop_u, u_refute = one(jnp.int32(round_idx))

        def t(a):
            return torch.from_numpy(np.array(a))

        return RoundDraws(tuple(int(s) for s in np.asarray(shifts)),
                          t(u_direct), t(u_proxy), t(drop_u), t(u_refute))

    return draws


def port_params(jax_params):
    return interop.params_from_fields(dataclasses.asdict(jax_params))


def port_world(jax_world):
    """The reference world carried over as numpy arrays, on the CPU."""
    arrays = {f.name: np.asarray(getattr(jax_world, f.name))
              for f in dataclasses.fields(jax_world)
              if f.name != "faults" and getattr(jax_world, f.name) is not None}
    arrays["faults"] = {f.name: np.asarray(getattr(jax_world.faults, f.name))
                        for f in dataclasses.fields(jax_world.faults)}
    return interop.world_from_arrays(arrays, device="cpu")


def assert_state_equal(jax_state, port_state):
    for name in STATE_FIELDS:
        want = np.asarray(getattr(jax_state, name))
        got = getattr(port_state, name).cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_metrics_equal(jax_metrics, port_metrics, rounds=slice(None)):
    assert set(port_metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        want = np.asarray(value)[rounds]
        got = port_metrics[name].cpu().numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
