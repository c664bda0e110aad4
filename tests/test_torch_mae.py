"""The port's masking ops and VTMAE masked-reconstruction loss against the JAX package on the CPU.

Masks are injected, never sampled on both sides: the test builds one ModalMask from numpy and
the JAX side receives it by monkeypatching ``m3l_tpu.models.vtmae.random_modal_masking`` inside
the test. Weights are the JAX module's, carried over by load_jax_params; everything is f32.
Tolerances: index ops exactly; the loss and every parameter's gradient at rtol 2e-4 / atol 2e-5,
because EarlyCNN convolutions and patch embeddings are on the path (tests/test_torch_modules.py
gives the reason).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.ops.masking import ModalMask as JModalMask, gather_tokens as jgather, restore_tokens as jrestore
from m3l_tpu_torch.models import VTT, VTMAE, VTTConfig
from m3l_tpu_torch.ops.masking import gather_tokens, mask_from_indices, random_modal_masking, restore_tokens
from m3l_tpu_torch.utils.convert import _target, load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=2e-4, atol=2e-5)
SIZES, MASKED = [64, 64, 64], [60, 61, 61]  # 95% of 192 tokens, the reference's split


def flat_state(state) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for path, v in nnx.to_flat_state(state)}


def numpy_mask(batch, seed, sizes=SIZES, masked=MASKED):
    """(masked_idx, unmasked_idx) from per-row numpy permutations of each segment."""
    rng = np.random.default_rng(seed)
    rows_m, rows_u = [], []
    for _ in range(batch):
        ms, us, off = [], [], 0
        for n, m in zip(sizes, masked):
            perm = rng.permutation(n) + off
            ms.append(perm[:m])
            us.append(perm[m:])
            off += n
        rows_m.append(np.concatenate(ms))
        rows_u.append(np.concatenate(us))
    return np.stack(rows_m), np.stack(rows_u)


def both_masks(masked_idx, unmasked_idx):
    restore = np.argsort(np.concatenate([unmasked_idx, masked_idx], axis=1), axis=1)
    jm = JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked_idx, unmasked_idx, restore)))
    return jm, mask_from_indices(torch.from_numpy(masked_idx), torch.from_numpy(unmasked_idx))


def test_gather_and_restore_match_jax():
    rng = np.random.default_rng(0)
    tokens = rng.normal(size=(3, 192, 8)).astype(np.float32)
    kept = rng.normal(size=(3, 10, 8)).astype(np.float32)
    mask_token = rng.normal(size=(8,)).astype(np.float32)
    jm, tm = both_masks(*numpy_mask(3, seed=1))
    np.testing.assert_array_equal(
        gather_tokens(torch.from_numpy(tokens), tm.unmasked_idx).numpy(), np.asarray(jgather(jnp.asarray(tokens), jm.unmasked_idx))
    )
    np.testing.assert_array_equal(
        restore_tokens(torch.from_numpy(kept), torch.from_numpy(mask_token), tm).numpy(),
        np.asarray(jrestore(jnp.asarray(kept), jnp.asarray(mask_token), jm)),
    )
    np.testing.assert_array_equal(tm.restore_idx.numpy(), np.asarray(jm.restore_idx))


def test_random_modal_masking_draws_segment_permutations():
    gen = torch.Generator().manual_seed(3)
    mask = random_modal_masking(gen, 4, SIZES, MASKED)
    assert mask.masked_idx.shape == (4, 182) and mask.unmasked_idx.shape == (4, 10) and mask.restore_idx.shape == (4, 192)
    off = 0
    m_off = 0
    for n, m in zip(SIZES, MASKED):
        seg_masked = mask.masked_idx[:, m_off : m_off + m]
        seg_kept = mask.unmasked_idx[:, off - m_off : off - m_off + n - m]
        both = torch.cat([seg_masked, seg_kept], dim=1).sort(dim=1).values
        assert torch.equal(both, torch.arange(off, off + n).expand(4, n))  # a permutation of the segment
        off += n
        m_off += m
    tokens = torch.randn(4, 192, 5, generator=gen)
    kept = gather_tokens(tokens, mask.unmasked_idx)
    masked = gather_tokens(tokens, mask.masked_idx)
    assert torch.equal(gather_tokens(torch.cat([kept, masked], 1), mask.restore_idx), tokens)  # restore_idx inverts
    again = random_modal_masking(torch.Generator().manual_seed(3), 4, SIZES, MASKED)
    assert torch.equal(again.masked_idx, mask.masked_idx)
    assert not torch.equal(random_modal_masking(gen, 4, SIZES, MASKED).masked_idx, mask.masked_idx)


def test_mask_counts_match_jax():
    cfg = JVTTConfig(dim=64, depth=1, heads=2, mlp_dim=128, num_tactiles=2)
    jm = JVTMAE(JVTT(cfg, rngs=nnx.Rngs(0)), decoder_dim=64, masking_ratio=0.95, rngs=nnx.Rngs(0))
    tm = VTMAE(VTT(VTTConfig(dim=64, depth=1, heads=2, mlp_dim=128, num_tactiles=2)), decoder_dim=64, masking_ratio=0.95)
    for use_vision in (True, False):
        for use_tactile in (True, False):
            if use_vision or use_tactile:
                assert tm._mask_counts(use_vision, use_tactile) == jm._mask_counts(use_vision, use_tactile)
    assert tm._mask_counts(True, True)[:2] == (SIZES, MASKED)


@pytest.mark.parametrize("early_conv,sincosmod", [(True, True), (True, False), (False, True), (False, False)])
def test_vtmae_loss_and_gradients_match_jax(monkeypatch, early_conv, sincosmod):
    kw = dict(decoder_dim=64, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
              early_conv_masking=early_conv, use_sincosmod_encodings=sincosmod)
    fs, batch = 2, 2
    jm = JVTMAE(JVTT(JVTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=fs), rngs=nnx.Rngs(0)),
                rngs=nnx.Rngs(0), **kw)
    tm = VTMAE(VTT(VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=fs)), **kw)
    load_jax_params(tm, flat_state(nnx.state(jm, nnx.Param)))
    rng = np.random.default_rng(7)
    x = {"image": rng.random((batch, 64, 64, 3 * fs), dtype=np.float32),
         "tactile1": rng.random((batch, 32, 32, 3 * fs), dtype=np.float32),
         "tactile2": rng.random((batch, 32, 32, 3 * fs), dtype=np.float32)}
    jmask, tmask = both_masks(*numpy_mask(batch, seed=8))
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, masked: jmask)

    jloss, jgrads = nnx.value_and_grad(lambda m: m({k: jnp.asarray(v) for k, v in x.items()}, jax.random.PRNGKey(0)))(jm)
    loss = tm.masked_loss({k: torch.from_numpy(v) for k, v in x.items()}, tmask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)

    params = dict(tm.named_parameters())
    for key, g in flat_state(jgrads).items():
        *path, leaf = key.split("/")
        name, convert = _target(tm.get_submodule(".".join(path)), leaf)
        p = params[".".join([*path, name])]
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, convert(g), err_msg=key, **TOL)
