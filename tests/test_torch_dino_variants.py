"""The PPO feature variants of the port against the JAX package on the CPU: the DINOv2 backbone and
its torch-checkpoint loaders, ``FrozenEncoderFeatures``, ``DinoCatMAEFeatures`` (default,
tactile-only and vision-only-control), ``VTMAECnn``, one PPO update phase per variant, and the
four CLIs (``traindino``, ``train_dino_cat_mae``, ``train_dino_tac_mae``, ``train_cnn``).

The method of ``tests/test_torch_train_phase.py``: the same weights (one seeded torch-layout DINOv2
state dict loaded by both packages' loaders, or the JAX module's parameters carried by
``load_jax_params``), the same numpy-seeded inputs, and masks injected, never sampled. The models
are small: a 64-wide DINOv2 of depth 2 on 42 x 42 crops (3 x 3 patches of 14), a VTT of depth 1 at
dim 64. Tolerances: the patch convolution or an EarlyCNN is on every path, so rtol 2e-4 / atol
2e-5 (``tests/jax_params.py`` ``CONV_TOL``); the updated parameters to 1e-2 * lr, as in
``tests/test_torch_train_phase.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTMAECnn as JVTMAECnn, VTTConfig as JVTTConfig
from m3l_tpu.models.dinov2_interop import DINOv2Backbone as JDINOv2Backbone
from m3l_tpu.models.dinov2_interop import DINOv2LinearSegHead as JSegHead
from m3l_tpu.models.dinov2_interop import load_torch_dinov2_state as jload_dinov2
from m3l_tpu.models.dinov2_interop import load_torch_linear_seg_head as jload_seg_head
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import PPOMAE as JPPOMAE, ActorCritic as JActorCritic, MAEFeatures as JMAEFeatures
from m3l_tpu.rl.dino_fusion_features import DinoCatMAEFeatures as JDinoCat
from m3l_tpu.rl.frozen_features import FrozenEncoderFeatures as JFrozen
from m3l_tpu.utils.obs import vt_load as jvt_load
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.models import VTMAE, VTT, VTMAECnn, VTTConfig
from m3l_tpu_torch.models.dinov2_interop import (
    DINOv2Backbone,
    DINOv2LinearSegHead,
    dinov2_vits14,
    load_torch_dinov2_state,
    load_torch_linear_seg_head,
)
from m3l_tpu_torch.ops.masking import mask_from_indices
from m3l_tpu_torch.rl import PPOMAE, ActorCritic, DinoCatMAEFeatures, FrozenEncoderFeatures, MAEFeatures
from m3l_tpu_torch.utils.convert import load_jax_params
from m3l_tpu_torch.utils.obs import vt_load
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=2e-4, atol=2e-5)
D, HEADS, DEPTH, REG, CROP = 64, 2, 2, 4, 42
FS, N_ENVS, N_STEPS, EPOCHS, LR = 2, 2, 8, 2, 1e-4
BATCH = N_ENVS * N_STEPS
SMALL = 28  # the fusion variants' image and tactile maps: 2 x 2 patches of 14


def torch_dinov2_state(rng, img=CROP, d=D, depth=DEPTH, reg=REG) -> dict:
    """A random DINOv2 state dict in torch-hub layout, LayerScale far from its 1e-5 init so every
    block matters."""
    def r(*shape, scale=0.05):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)

    sd = {"cls_token": r(1, 1, d), "register_tokens": r(1, reg, d), "pos_embed": r(1, 1 + (img // 14) ** 2, d),
          "patch_embed.proj.weight": r(d, 3, 14, 14), "patch_embed.proj.bias": r(d), "norm.weight": 1.0 + r(d), "norm.bias": r(d)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1.0 + r(d), p + "norm1.bias": r(d), p + "attn.qkv.weight": r(3 * d, d),
                   p + "attn.qkv.bias": r(3 * d), p + "attn.proj.weight": r(d, d), p + "attn.proj.bias": r(d),
                   p + "ls1.gamma": r(d, scale=0.3), p + "norm2.weight": 1.0 + r(d), p + "norm2.bias": r(d),
                   p + "mlp.fc1.weight": r(4 * d, d), p + "mlp.fc1.bias": r(4 * d), p + "mlp.fc2.weight": r(d, 4 * d),
                   p + "mlp.fc2.bias": r(d), p + "ls2.gamma": r(d, scale=0.3)})
    return sd


def dino_pair(seed=0, img=CROP):
    sd = torch_dinov2_state(np.random.default_rng(seed), img=img)
    jd = JDINOv2Backbone(img_size=(img, img), patch_size=14, embed_dim=D, depth=DEPTH, num_heads=HEADS, num_register_tokens=REG,
                         rngs=nnx.Rngs(seed))
    td = DINOv2Backbone(img_size=(img, img), patch_size=14, embed_dim=D, depth=DEPTH, num_heads=HEADS, num_register_tokens=REG)
    assert load_torch_dinov2_state(td, {"backbone." + k: v for k, v in sd.items()}) == jload_dinov2(jd, sd)
    return jd, td, sd


def flat_state(*states) -> dict:
    out = {}
    for state in states:
        for path, v in nnx.to_flat_state(state):
            out["/".join(str(p) for p in path)] = np.asarray(v.get_value() if hasattr(v, "get_value") else v)
    return out


def carry(jmodule, tmodule):
    load_jax_params(tmodule, flat_state(nnx.state(jmodule, nnx.Param)))
    return tmodule


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def raw_obs(b, img, tac, seed=0, fs=FS) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, fs, img, img, 3), dtype=np.uint8),
            "tactile": rng.uniform(-1, 1, (b, fs, 6, tac, tac)).astype(np.float32)}


def packed(o, fs=FS):
    return jvt_load({k: jnp.asarray(v) for k, v in o.items()}, frame_stack=fs), vt_load({k: torch.from_numpy(v) for k, v in o.items()}, frame_stack=fs)


def tiled_mask(sizes, masked, batch, seed=0):
    """One mask realisation over modality segments of ``sizes`` (``masked`` of each masked),
    tiled over the batch: (masked, kept) index arrays."""
    rng = np.random.default_rng(seed)
    ms, us, off = [], [], 0
    for n, m in zip(sizes, masked):
        perm = rng.permutation(n) + off
        ms.append(perm[:m])
        us.append(perm[m:])
        off += n
    return tuple(np.tile(np.concatenate(p)[None], (batch, 1)) for p in (ms, us))


def inject(monkeypatch, masked, kept):
    """The JAX MAE's masking returns this mask (cut to the batch); returns the port's."""
    restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
    full = [jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)]
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, m: JModalMask(*(a[:b] for a in full)))
    return mask_from_indices(torch.from_numpy(masked), torch.from_numpy(kept))


# ---------------------------------------------------------------------- DINOv2 and its loaders


@pytest.mark.parametrize("img", [CROP, 56], ids=["native-grid", "interpolated-grid"])
def test_dinov2_backbone_matches_jax(img):
    """CLS, registers, patches and the pre-norm sequence at the native 3 x 3 grid and at 4 x 4, where
    the position table is resized bicubically by both (the port mirrors jax.image.resize)."""
    jd, td, _ = dino_pair()
    x = np.random.default_rng(1).random((2, img, img, 3), dtype=np.float32)
    want, got = jd.forward_features(jnp.asarray(x)), td.forward_features(torch.from_numpy(x))
    for k in want:
        close(got[k], want[k], err_msg=k, **TOL)
    close(td(torch.from_numpy(x)), jd(jnp.asarray(x)))
    assert got["x_norm_regtokens"].shape == (2, REG, D) and got["x_norm_patchtokens"].shape == (2, (img // 14) ** 2, D)


def test_dinov2_loader_is_strict_and_counts_like_jax():
    jd, td, sd = dino_pair()
    n = sum(p.numel() for p in td.parameters())
    assert load_torch_dinov2_state(td, sd) == jload_dinov2(jd, sd) == n
    # the JAX module's parameters carry into the port by path and give the same module
    twin = carry(jd, DINOv2Backbone(img_size=(CROP, CROP), patch_size=14, embed_dim=D, depth=DEPTH, num_heads=HEADS))
    assert all(torch.equal(a, b) for a, b in zip(twin.parameters(), td.parameters()))
    # numpy values and the hub's unused mask token load; an unknown or a missing key raises
    assert load_torch_dinov2_state(td, {**{k: v.numpy() for k, v in sd.items()}, "mask_token": torch.zeros(1, D)}) == n
    with pytest.raises(KeyError, match="unused.*blocks.9.ls1.gamma"):
        load_torch_dinov2_state(td, {**sd, "blocks.9.ls1.gamma": torch.zeros(D)})
    with pytest.raises(KeyError, match="unset.*register_tokens"):
        load_torch_dinov2_state(td, {k: v for k, v in sd.items() if k != "register_tokens"})
    with pytest.raises(ValueError, match="pos_embed"):
        load_torch_dinov2_state(td, {**sd, "pos_embed": torch.zeros(1, 5, D)})


def test_dinov2_vits14_layout():
    torch.manual_seed(0)
    dino = dinov2_vits14(img_size=(70, 70), depth=1)
    assert dino.patch_embed.grid == (5, 5) and dino.register_tokens.shape == (1, 4, 384)
    assert dino.pos_embed.shape == (1, 26, 384) and dino.blocks[0].ls1.gamma.eq(1e-5).all()
    assert dino.blocks[0].attn.num_heads == 6 and dino.norm.eps == 1e-6
    assert dino(torch.rand(3, 70, 70, 3)).shape == (3, 384)


def test_seg_head_matches_jax():
    rng = np.random.default_rng(3)
    sd = {"decode_head.bn.weight": 1.0 + rng.normal(size=D) * 0.1, "decode_head.bn.bias": rng.normal(size=D) * 0.1,
          "decode_head.bn.running_mean": rng.normal(size=D) * 0.1, "decode_head.bn.running_var": rng.uniform(0.5, 2, D),
          "decode_head.conv_seg.weight": rng.normal(size=(5, D, 1, 1)) * 0.1, "decode_head.conv_seg.bias": rng.normal(size=5),
          "decode_head.bn.num_batches_tracked": np.array(7)}
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    jh, th = JSegHead(D, 5, rngs=nnx.Rngs(0)), DINOv2LinearSegHead(D, 5)
    assert load_torch_linear_seg_head(th, {"state_dict": sd}) == jload_seg_head(jh, {"state_dict": sd}) == sum(p.numel() for p in th.parameters())
    tokens = rng.normal(size=(2, 9, D)).astype(np.float32)
    close(th(torch.from_numpy(tokens), (3, 3)), jh(jnp.asarray(tokens), (3, 3)), rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError, match="unused"):
        load_torch_linear_seg_head(th, {**sd, "decode_head.extra": torch.zeros(1)})


# ---------------------------------------------------------------------- the feature extractors


def frozen_pair(seed=0):
    jd, _, _ = dino_pair(seed)
    jf = JFrozen(jd, D, frame_stack=FS, crop_size=CROP, rngs=nnx.Rngs(seed + 1))
    return jf, carry(jf, FrozenEncoderFeatures(DINOv2Backbone(img_size=(CROP, CROP), patch_size=14, embed_dim=D, depth=DEPTH,
                                                              num_heads=HEADS), D, frame_stack=FS, crop_size=CROP))


def test_frozen_features_match_jax():
    """Crops modality-major (the image's 2 frames, then tactile1's, then tactile2's), resized 64 -> 42
    and 32 -> 42 bilinearly as jax.image.resize does, then the encoder, the post transformer, the pool."""
    jf, tf = frozen_pair()
    o = raw_obs(3, 64, 32)
    jx, tx = packed(o)
    close(tf._crops(tx), jf._crops(jx), rtol=1e-5, atol=1e-6)
    assert tf._crops(tx).shape == (3, 3 * FS, CROP, CROP, 3)
    close(tf.from_packed(tx), jf.from_packed(jx))
    close(tf({k: torch.from_numpy(v) for k, v in o.items()}), jf({k: jnp.asarray(v) for k, v in o.items()}))


def cat_pair(seed=0, **kw):
    cfg = dict(image_size=(SMALL, SMALL), tactile_size=(SMALL, SMALL), image_patch_size=14, tactile_patch_size=14, dim=D,
               depth=1, heads=2, mlp_dim=2 * D, num_tactiles=2, frame_stack=FS)
    mae_kw = dict(masking_ratio=0.8, decoder_dim=D, decoder_depth=1, decoder_heads=2, early_conv_masking=False)
    rngs = nnx.Rngs(seed)
    jd, _, _ = dino_pair(seed)
    jf = JDinoCat(JVTMAE(JVTT(JVTTConfig(**cfg), rngs=rngs), rngs=rngs, **mae_kw), jd, D, dino_dim=D, frame_stack=FS,
                  dino_crop=CROP, rngs=rngs, **kw)
    td = DINOv2Backbone(img_size=(CROP, CROP), patch_size=14, embed_dim=D, depth=DEPTH, num_heads=HEADS)
    tf = DinoCatMAEFeatures(VTMAE(VTT(VTTConfig(**cfg)), **mae_kw), td, D, dino_dim=D, frame_stack=FS, dino_crop=CROP, **kw)
    return jf, carry(jf, tf)


CAT_MODES = {"default": {}, "tactile_only": dict(tactile_only_mae=True), "vision_only_control": dict(vision_only_control=True)}
# token segments (image, tactile1, tactile2) of the MAE's loss at mask 0.8: 12 tokens, 9 masked,
# 3 / 3 / 3; tactile-only: 8 tokens, 6 masked, 3 / 3
CAT_MASKS = {"default": ([4, 4, 4], [3, 3, 3]), "tactile_only": ([4, 4], [3, 3]), "vision_only_control": ([4, 4, 4], [3, 3, 3])}


@pytest.mark.parametrize("mode", list(CAT_MODES))
def test_dino_cat_features_and_mae_loss_match_jax(mode, monkeypatch):
    """The fused features (the middle frame's DINO CLS, resized 28 -> 42) and the MAE loss under an
    injected mask; the policy's fallback, the same pair apart, in the joint update's method."""
    jf, tf = cat_pair(**CAT_MODES[mode])
    o = raw_obs(3, SMALL, SMALL, seed=4)
    jx, tx = packed(o)
    close(tf.from_packed(tx), jf.from_packed(jx))
    masked, kept = tiled_mask(*CAT_MASKS[mode], 3)
    tmask = inject(monkeypatch, masked, kept)
    close(tf.mae_loss(tx, tmask), jf.mae_loss(jx, jax.random.PRNGKey(0)))
    assert tf.mae_modalities(o.keys()) == (mode != "tactile_only", True)
    jp = JActorCritic(jf, D, 3, rngs=nnx.Rngs(5))
    tp = carry(jp, ActorCritic(tf, D, 3))
    actions = np.random.default_rng(6).normal(size=(3, 3)).astype(np.float32)
    want = jp.evaluate_actions_packed_with_mae(jx, jnp.asarray(actions), jax.random.PRNGKey(0))
    got = tp.evaluate_actions_packed_with_mae(tx, torch.from_numpy(actions), tmask)
    for g, w in zip(got, want):
        close(g, w)


def test_dino_cat_weighted_pooling_matches_jax():
    jf, tf = cat_pair()
    tokens = np.random.default_rng(7).normal(size=(3, 12, D)).astype(np.float32)
    close(tf.weighted_pooling(torch.from_numpy(tokens)), jf.weighted_pooling(jnp.asarray(tokens)), rtol=1e-5, atol=1e-6)


def cnn_pair(seed=0, **kw):
    cfg = dict(dim=D, depth=1, heads=2, mlp_dim=2 * D, num_tactiles=2, frame_stack=FS)
    mae_kw = dict(decoder_dim=D, masking_ratio=0.95, decoder_depth=1, decoder_heads=2)
    rngs = nnx.Rngs(seed)
    jm = JVTMAECnn(JVTT(JVTTConfig(**cfg), rngs=rngs), rngs=rngs, **mae_kw, **kw)
    return jm, carry(jm, VTMAECnn(VTT(VTTConfig(**cfg)), **mae_kw, **kw))


@pytest.mark.parametrize("use_transformer", [False, True], ids=["raw-conv-tokens", "embeddings-use-transformer"])
def test_vtmae_cnn_matches_jax(use_transformer, monkeypatch):
    jm, tm = cnn_pair(embeddings_use_transformer=use_transformer)
    assert len(tm.early_conv_tactile_towers) == 2 and hasattr(tm, "early_conv_tactile")  # the shared tower stays, unused
    o = raw_obs(3, 64, 32, seed=8)
    jx, tx = packed(o)
    emb = tm.get_embeddings(tx)
    assert emb.shape == (3, 192, D)
    close(emb, jm.get_embeddings(jx))
    masked, kept = tiled_mask([64, 64, 64], [60, 61, 61], 3, seed=9)
    tmask = inject(monkeypatch, masked, kept)
    close(tm.masked_loss(tx, tmask), jm(jx, jax.random.PRNGKey(0)))


def test_cnn_rollout_and_update_features_differ_as_in_jax(monkeypatch):
    """The reference behaviour kept: under MAEFeatures the rollout's features are the raw conv
    tokens through the post transformer, the joint update's go through the embeddings and the
    encoder first. The port matches JAX at both sites, and the two sites differ."""
    jm, _ = cnn_pair()
    jf = JMAEFeatures(jm, D, frame_stack=FS, rngs=nnx.Rngs(1))
    tf = carry(jf, MAEFeatures(cnn_pair()[1], D, frame_stack=FS))
    jx, tx = packed(raw_obs(3, 64, 32, seed=10))
    masked, kept = tiled_mask([64, 64, 64], [60, 61, 61], 3, seed=11)
    tmask = inject(monkeypatch, masked, kept)
    rollout_feats = tf.from_packed(tx)
    update_feats, loss = tf.features_and_mae_loss(tx, tmask)
    jupdate, jloss = jf.features_and_mae_loss(jx, jax.random.PRNGKey(0))
    close(rollout_feats, jf.from_packed(jx))
    close(update_feats, jupdate)
    close(loss, jloss)
    assert (rollout_feats - update_feats).abs().max() > 1e-2


# ---------------------------------------------------------------------- the repairs


def cat_policy(**kw):
    return ActorCritic(cat_pair(**kw)[1], D, 3)


def small_env(size=SMALL):
    return SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FS, image_size=size, tactile_size=size) for i in range(N_ENVS)])


def test_joint_update_of_an_extractor_without_a_shared_pipeline():
    """DinoCatMAEFeatures has no features_and_mae_loss: the joint update takes its features and its
    MAE loss apart, as the JAX policy does (this raised AttributeError before)."""
    policy = cat_policy()
    x = vt_load({k: torch.from_numpy(v) for k, v in raw_obs(4, SMALL, SMALL).items()}, frame_stack=FS)
    mask = policy.features.mae.sample_mask(torch.Generator().manual_seed(0), 4)
    values, log_prob, entropy, mae_loss = policy.evaluate_actions_packed_with_mae(x, torch.zeros(4, 3), mask)
    assert values.shape == log_prob.shape == entropy.shape == (4,) and mae_loss.item() > 0


def test_plain_ppo_over_frozen_features_draws_no_mask():
    """Plain PPO over frozen features draws its permutations and no mask, and needs no ``.mae``
    (this raised AttributeError before)."""
    _, tf = frozen_pair()
    plain = PPOMAE(ActorCritic(tf, D, 3), small_env(64), n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, train_mae=False,
                   frame_stack=FS, device="cpu")
    idx, masks = plain.sample_updates(["image", "tactile"])
    assert idx.shape == (EPOCHS, BATCH) and masks == [None] * EPOCHS


@pytest.mark.parametrize("tactile_only,n,counts", [(True, 8, [3, 3]), (False, 12, [3, 3, 3])], ids=["tactile-only", "image-and-tactile"])
def test_sample_updates_follow_the_features_modalities(tactile_only, n, counts):
    """The tactile-only MAE's masks cover its 8 tactile tokens (3 of each sensor's 4 masked), not
    the 12 of image + tactile (the image's split was drawn before)."""
    model = PPOMAE(cat_policy(tactile_only_mae=tactile_only), small_env(), n_steps=N_STEPS, batch_size=BATCH,
                   n_epochs=EPOCHS, frame_stack=FS, device="cpu")
    _, masks = model.sample_updates(["image", "tactile"])
    m = masks[0]
    assert m.masked_idx.shape == (BATCH, sum(counts)) and m.unmasked_idx.shape == (BATCH, n - sum(counts))
    assert torch.equal(torch.sort(torch.cat([m.masked_idx, m.unmasked_idx], 1), 1)[0], torch.arange(n).expand(BATCH, n))
    seg = m.masked_idx[0] // 4
    assert [int((seg == s).sum()) for s in range(len(counts))] == counts
    x = vt_load({k: torch.from_numpy(v) for k, v in raw_obs(BATCH, SMALL, SMALL).items()}, frame_stack=FS)
    assert torch.isfinite(model.policy.features.mae_loss(x, m))


def test_policy_adam_covers_the_frozen_encoder_with_zero_steps():
    """The policy's Adam spans every parameter, the frozen DINO's too (JAX's other_params); their
    gradients are None, enter as zeros and move them by exactly 0."""
    _, tf = frozen_pair()
    policy = ActorCritic(tf, D, 3)
    model = PPOMAE(policy, small_env(64), n_steps=4, batch_size=4, n_epochs=1, train_mae=False, frame_stack=FS, device="cpu")
    assert model.optimizer.mu.numel() == sum(p.numel() for p in policy.parameters())
    before = {n: p.detach().clone() for n, p in policy.named_parameters()}
    model.learn(total_timesteps=16)
    assert model.last_metrics["mae_loss"] == 0.0
    assert all(torch.equal(p, before[n]) for n, p in policy.named_parameters() if n.startswith("features.encoder."))
    assert any(not torch.equal(p, before[n]) for n, p in policy.named_parameters() if n.startswith("features.post."))


# ---------------------------------------------------------------------- the update phase per variant


def jenv(size):
    return JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS, image_size=size, tactile_size=size) for i in range(N_ENVS)])


def variant_rollout(img, tac, seed=0):
    rng = np.random.default_rng(seed)
    data = {"obs": raw_obs(BATCH, img, tac, seed=seed + 100),
            "actions": rng.normal(size=(BATCH, 3)).astype(np.float32),
            "values": rng.normal(size=BATCH).astype(np.float32),
            "log_probs": (rng.normal(size=BATCH) - 3.0).astype(np.float32)}
    tail = (rng.normal(size=(N_STEPS, N_ENVS)).astype(np.float32), (rng.random((N_STEPS, N_ENVS)) < 0.2).astype(np.float32),
            rng.normal(size=N_ENVS).astype(np.float32), np.array([0.0, 1.0], np.float32))
    return data, tail


def variant_pair(name):
    """(JAX policy, port policy with its weights, image size, MAE mask segments or None, PPOMAE kw)."""
    if name == "frozen":
        jf, tf = frozen_pair()
        size, segments, kw = 64, None, dict(train_mae=False)
    elif name == "cnn":
        jm, tm = cnn_pair()
        jf, tf = JMAEFeatures(jm, D, frame_stack=FS, rngs=nnx.Rngs(1)), MAEFeatures(tm, D, frame_stack=FS)
        size, segments, kw = 64, ([64, 64, 64], [60, 61, 61]), {}
    else:
        jf, tf = cat_pair(**CAT_MODES[name])
        size, segments, kw = SMALL, CAT_MASKS[name], {}
    jp = JActorCritic(jf, D, 3, rngs=nnx.Rngs(2))
    return jp, ActorCritic(tf, D, 3), size, segments, kw


@pytest.mark.parametrize("name", ["frozen", "default", "tactile_only", "cnn"])
def test_train_phase_matches_jax(name, monkeypatch):
    """JAX ``PPOMAE._train_phase`` against the port's ``train_phase``: one minibatch per epoch (batch =
    buffer), one mask tiled over it, the same weights and rollout. frozen: traindino's plain PPO;
    default and tactile_only: the fusion variants' joint update (24 + 12 layers at full width);
    cnn: the CNN-variant MAE's joint update through its shared pipeline."""
    jp, tp, size, segments, kw = variant_pair(name)
    data, (rewards, starts, last_values, last_dones) = variant_rollout(size, 32 if size == 64 else size)
    masks = [None] * EPOCHS
    if segments is not None:
        masked, kept = tiled_mask(*segments, BATCH, seed=12)
        masks = [inject(monkeypatch, masked, kept)] * EPOCHS
    jmodel = JPPOMAE(jp, jenv(size), learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS, **kw)
    init = flat_state(jmodel.mae_params, jmodel.other_params)
    load_jax_params(tp, init)
    start = {n: p.detach().clone() for n, p in tp.named_parameters()}
    model = PPOMAE(tp, small_env(size), learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS,
                   device="cpu", **kw)
    jput = lambda a: jax.tree.map(jnp.asarray, a)  # noqa: E731
    mae_p, other_p, _, _, jmetrics = jmodel._train_phase(
        jmodel.mae_params, jmodel.other_params, jmodel.policy_opt_state, jmodel.mae_opt_state, jput(data),
        jnp.asarray(rewards), jnp.asarray(starts), jnp.asarray(last_values), jnp.asarray(last_dones), jax.random.PRNGKey(0),
    )
    tput = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tdata = {"obs": {k: tput(v) for k, v in data["obs"].items()}, **{k: tput(data[k]) for k in ("actions", "values", "log_probs")}}
    idx = torch.stack([torch.randperm(BATCH, generator=torch.Generator().manual_seed(e)) for e in range(EPOCHS)])
    metrics = model.train_phase(tdata, tput(rewards), tput(starts), tput(last_values), tput(last_dones), idx, masks)
    assert metrics.keys() == jmetrics.keys()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), err_msg=k, **TOL)
    assert (metrics["mae_loss"] == 0.0) == (name == "frozen")
    carried = variant_pair(name)[1]
    load_jax_params(carried, flat_state(mae_p, other_p))
    expected = dict(carried.named_parameters())
    for n, p in model.policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[n].detach().numpy(), rtol=0, atol=1e-2 * LR, err_msg=n)
    assert model.optimizer.count == EPOCHS
    # not vacuous: Adam's first steps move most parameters by ~lr each; a frozen encoder by exactly 0
    moved = {n: (p.detach() - start[n]).abs().max().item() for n, p in model.policy.named_parameters()}
    assert max(moved.values()) > LR
    assert all(v == 0.0 for n, v in moved.items() if n.startswith(("features.encoder.", "features.dino_encoder.")))


# ---------------------------------------------------------------------- the CLIs


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices) for a in parser._actions if a.dest != "help"}


CLIS = ["traindino", "train_dino_cat_mae", "train_dino_tac_mae", "train_cnn"]


@pytest.mark.parametrize("name", CLIS)
def test_parser_has_the_jax_flags_and_defaults_plus_device(name):
    import importlib

    ours = _options(importlib.import_module(f"m3l_tpu_torch.cli.{name}").build_parser())
    theirs = _options(importlib.import_module(f"m3l_tpu.cli.{name}").build_parser())
    assert set(ours) == set(theirs) | {"device"}
    for dest, (flags, default, _, choices) in theirs.items():
        assert ours[dest][0] == flags and ours[dest][1] == default and ours[dest][3] == choices, dest
    assert ours["device"][1] == "cuda"


TINY = ["--env", "FakeInsertion", "--n_envs", "2", "--rollout_length", "16", "--batch_size", "8", "--ppo_epochs", "1",
        "--mae_batch_size", "4", "--compute_dtype", "float32", "--subproc", "False", "--device", "cpu", "--verbose", "0"]


def test_traindino_main_loads_local_weights_and_keeps_them_frozen(tmp_path, capsys):
    from m3l_tpu_torch.cli import traindino

    torch.manual_seed(3)
    sd = dinov2_vits14(img_size=(70, 70)).state_dict()
    path = tmp_path / "dinov2_vits14_reg.pth"
    torch.save({"model": sd}, path)
    model = traindino.main(TINY + ["--total_timesteps", "32", "--dinov2_weights", str(path)])
    assert f"loaded {sum(v.numel() for v in sd.values()):,} params" in capsys.readouterr().out
    assert model.num_timesteps == 32 and model.iteration == 2 and not model.train_mae
    assert model.last_metrics["mae_loss"] == 0.0
    assert all(torch.equal(p, sd[n]) for n, p in model.policy.features.encoder.named_parameters())
    assert model.policy.features.encoder.dtype == torch.float32
    traindino.main(TINY + ["--total_timesteps", "16"])
    assert "WARNING: no --dinov2_weights given" in capsys.readouterr().out


@pytest.mark.parametrize("name,flags", [
    ("train_dino_cat_mae", ["--frame_stack", "2"]),
    ("train_dino_cat_mae", ["--frame_stack", "2", "--separate_optimizer", "True"]),
    ("train_dino_tac_mae", ["--frame_stack", "1"]),
    ("train_cnn", ["--dim_embedding", "64", "--frame_stack", "2"]),
], ids=["cat-joint", "cat-separate", "tac-joint", "cnn-joint"])
def test_variant_cli_trains_on_the_cpu(name, flags, tmp_path):
    import importlib

    cli = importlib.import_module(f"m3l_tpu_torch.cli.{name}")
    argv = TINY + ["--total_timesteps", "32", *flags]
    if name != "train_cnn":
        torch.manual_seed(4)
        path = tmp_path / "dino.pth"
        torch.save({"state_dict": {"backbone." + k: v for k, v in dinov2_vits14(img_size=(70, 70)).state_dict().items()}}, path)
        argv += ["--dim_embedding", "32", "--dinov2_weights", str(path)]
    model = cli.main(argv)
    m = model.last_metrics
    assert model.num_timesteps == 32 and model.iteration == 2 and model.device == torch.device("cpu")
    assert all(np.isfinite(m[k]) for k in ("policy_loss", "value_loss", "loss")) and m["mae_loss"] > 0
    features = model.policy.features
    if name == "train_cnn":
        assert isinstance(features.mae, VTMAECnn)
    else:
        assert features.tactile_only_mae == (name == "train_dino_tac_mae")
        assert features.mae.config.image_size == (70, 70) and features.mae.config.num_patches == 75
        assert model.env.observation_space["image"].shape[-2] == 70
        loaded = torch.load(path)["state_dict"]
        assert all(torch.equal(p, loaded["backbone." + n]) for n, p in features.dino_encoder.named_parameters())
    assert (model.mae_optimizer is not None) == ("--separate_optimizer" in flags)


def test_tac_mae_main_adds_the_flag_as_jax_does(monkeypatch):
    from m3l_tpu_torch.cli import train_dino_cat_mae, train_dino_tac_mae

    seen = []
    monkeypatch.setattr(train_dino_tac_mae, "_cat_main", lambda argv: seen.append(argv))
    train_dino_tac_mae.main(["--seed", "1"])
    train_dino_tac_mae.main(["--tactile_only_mae", "False"])
    assert seen == [["--seed", "1", "--tactile_only_mae", "True"], ["--tactile_only_mae", "False"]]
    assert train_dino_tac_mae.build_parser().parse_args([]).tactile_only_mae
    assert not train_dino_cat_mae.build_parser().parse_args([]).tactile_only_mae


@pytest.mark.parametrize("name", CLIS)
def test_variant_f32_check_sees_a_dropped_key(name, tmp_path):
    """chip_smoke.py holds one f32 update of each variant's CLI model on the card to
    VARIANT_F32_TOL of the CPU's, the DINO from its seeded weights. Two CPU runs of the same update
    agree exactly; one key left out of every attention layer (the frozen DINO's too) moves the
    losses, the gradient and the updated parameters past it."""
    from chip_smoke import VARIANT_F32_TOL, seeded_dinov2_weights, update_errors
    from m3l_tpu_torch.profile_paths import variant_model

    argv = () if name == "train_cnn" else ("--dinov2_weights", seeded_dinov2_weights(tmp_path / "dino.pth"))

    def model(dropping=False):
        m = variant_model(name, "cpu", "float32", 8, argv)
        for attn in (mod for mod in m.policy.modules() if type(mod).__name__ == "Attention") if dropping else ():
            def drop_last_key(x, key_mask=None, forward=attn.forward):
                keep = torch.ones(x.shape[:2], dtype=torch.bool)
                keep[:, -1] = False
                return forward(x, keep)
            attn.forward = drop_last_key
        return m

    same = update_errors(model(), model(), 8)
    assert same["loss_rel"] == same["grad_rel"] == same["param_per_lr"] == 0.0
    dropped = update_errors(model(), model(dropping=True), 8)
    tol = VARIANT_F32_TOL[name]
    assert all(dropped[k] > tol[k] for k in tol), dropped
