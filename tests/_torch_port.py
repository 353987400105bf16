"""Shared by the port's tests: the replay of the reference's draws, and
a fixture that keeps torch to one intra-op thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.rng import DrawSource, SlotDraws


class JaxReplay(DrawSource):
    """The reference fleet chunk's draws (`repro.sharding.sim`), per slot:
    key_t = fold_in(PRNGKey(seed), t); k_arr, k_algo = split(key_t);
    k_n, k_t = split(k_arr); k_hot, k_u = split(k_t);
    _, k_serve = split(k_algo)."""

    def __init__(self, seed, lam, batch, num_servers):
        base = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        lam = jnp.float32(lam)

        def draws(t):
            k_arr, k_algo = jax.random.split(jax.random.fold_in(base, t))
            k_n, k_t = jax.random.split(k_arr)
            n = jnp.minimum(jax.random.poisson(k_n, lam), batch)
            k_hot, k_u = jax.random.split(k_t)
            _, k_serve = jax.random.split(k_algo)
            return (n, jax.random.uniform(k_hot, (batch,)),
                    jax.random.uniform(k_u, (batch, 3)),
                    jax.random.uniform(k_serve, (num_servers,)))

        self._draws = jax.jit(draws)

    def slot(self, t):
        n, u_hot, r, u_serve = (np.asarray(x)
                                for x in self._draws(jnp.int32(t)))
        return SlotDraws(torch.tensor(int(n)), torch.tensor(u_hot),
                         torch.tensor(r), torch.tensor(u_serve))


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """The port's CPU tensors are small; torch's intra-op thread pool
    only oversubscribes the cores when several test workers share them
    (measured: 2.4x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
