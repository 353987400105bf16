"""internvl2-2b's vision frontend in the port against the JAX reference on
the CPU, float32, at its smoke config (4 layers, d_model 256, GQA 2/1,
head dim 16, 8 stub frontend rows), the weights handed over with
`params.from_reference`:

  * `forward` with ``frontend`` under every ``impl`` within 1e-4: the
    frontend rows cast to the model dtype and put before the token
    embeddings, positions ``arange`` over the whole stream, logits of
    Nf + T rows;
  * a prefill of the frontend and the first tokens, then decode steps
    from length Nf + T, against the full forward (the reference's 2e-3 /
    5e-3) and the reference's decode (1e-4): the frontend rows are causal
    over the whole stream, as in the reference;
  * a bf16 frontend cast to float32 equal to the float32 one.

`lm_loss` with ``frontend`` (its rows dropped from the loss) and its
gradients, and three train steps, are held in tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import params as RP, transformer as RT
from repro_torch.configs import registry
from repro_torch.models import params as P, transformer as T
from _torch_port import modality_inputs
from _torch_port import single_torch_thread  # noqa: F401

ARCH = "internvl2_2b"


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = rregistry.get_smoke_config(ARCH), \
        registry.get_smoke_config(ARCH)
    rprm = RP.init_params(rcfg, jax.random.PRNGKey(4))
    prm = P.from_reference(jax.tree.map(np.asarray, rprm), device="cpu")
    front = modality_inputs(cfg, 2, seed=5)["frontend"]
    return rcfg, rprm, cfg, prm, front


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_ssd"])
def test_forward_with_frontend_matches_reference(model, impl):
    rcfg, rprm, cfg, prm, front = model
    tok = _tokens(cfg, 2, 12, seed=6)
    want, _, _ = RT.forward(rprm, rcfg, jnp.asarray(tok),
                            frontend=jnp.asarray(front), impl=impl,
                            remat=False)
    got, caches, aux = T.forward(prm, cfg, torch.tensor(tok),
                                 frontend=torch.tensor(front), impl=impl)
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, cfg.num_frontend_tokens + 12, cfg.padded_vocab)
    _close(got, want, 1e-4)
    # the stream's positions are arange over the frontend rows and tokens
    pos = torch.arange(20, dtype=torch.int32)[None].expand(2, 20)
    again, _, _ = T.forward(prm, cfg, torch.tensor(tok),
                            frontend=torch.tensor(front), positions=pos,
                            impl=impl)
    assert torch.equal(again, got)


def test_frontend_is_cast_to_the_model_dtype(model):
    _, _, cfg, prm, front = model
    tok = torch.tensor(_tokens(cfg, 2, 6, seed=7))
    f32 = torch.tensor(front).to(torch.bfloat16).float()
    a, _, _ = T.forward(prm, cfg, tok, frontend=f32)
    b, _, _ = T.forward(prm, cfg, tok,
                        frontend=torch.tensor(front).to(torch.bfloat16))
    assert torch.equal(a, b)


def test_prefill_with_frontend_then_decode(model):
    """Prefill Nf frontend rows and T text tokens; the decode starts at
    length Nf + T."""
    rcfg, rprm, cfg, prm, front = model
    b, t0, tpre = 2, 12, 8
    nf = cfg.num_frontend_tokens
    tok = _tokens(cfg, b, t0, seed=8)
    full, _, _ = T.forward(prm, cfg, torch.tensor(tok),
                           frontend=torch.tensor(front))
    rfull, _, _ = RT.forward(rprm, rcfg, jnp.asarray(tok),
                             frontend=jnp.asarray(front), remat=False)
    _close(full, rfull, 1e-4)
    caches = T.init_caches(cfg, b, 32, device="cpu")
    rcaches = RT.init_caches(rcfg, b, 32)
    pre, caches, _ = T.forward(prm, cfg, torch.tensor(tok[:, :tpre]),
                               frontend=torch.tensor(front), caches=caches,
                               impl="pallas")
    _, rcaches, _ = RT.forward(rprm, rcfg, jnp.asarray(tok[:, :tpre]),
                               frontend=jnp.asarray(front), caches=rcaches,
                               remat=False)
    assert pre.shape[1] == nf + tpre
    _close(pre, full[:, :nf + tpre], 2e-3)
    kv = caches["stage0"]["sub0"]["kv"]
    assert (kv["pos"][:, :, :nf + tpre] >= 0).all()
    assert (kv["pos"][:, :, nf + tpre:] == -1).all()
    rstep = jax.jit(lambda t, n, c: RT.decode_step(rprm, rcfg, t, n, c))
    for t in range(tpre, t0):
        lengths = np.full((b,), nf + t, np.int32)
        lg, caches = T.decode_step(prm, cfg, torch.tensor(tok[:, t:t + 1]),
                                   torch.tensor(lengths), caches)
        rlg, rcaches = rstep(jnp.asarray(tok[:, t:t + 1]),
                             jnp.asarray(lengths), rcaches)
        _close(lg[:, 0], full[:, nf + t], 5e-3)
        _close(lg, rlg, 1e-4)
