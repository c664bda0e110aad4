"""The CNN-variant VTMAE (counterpart of ``m3l_tpu/models/vtmae_cnn.py`` ``VTMAECnn``): one EarlyCNN
tower per tactile sensor, and ``get_embeddings`` that returns the raw conv tokens.

* ``_tokens`` (the masked loss, and the joint update's shared pipeline) runs the image tower and
  one tower per sensor, then adds the modality and sin/cos embeddings as ``VTMAE`` does;
* ``get_embeddings`` (the policy's rollout features) returns the towers' tokens with no positional
  or modality embedding and no transformer, unless ``embeddings_use_transformer`` is set.

The shared ``early_conv_tactile`` tower that ``VTMAE`` builds stays, unused, as it does in the JAX
module, so JAX weights carry over whole. Under ``rl/policy.py`` ``MAEFeatures`` in joint mode the
rollout's features (``get_embeddings``) and the update's (``features_and_mae_loss``: ``_tokens``,
the encoder, the post transformer) differ, exactly as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.early_cnn import EarlyCNN
from .vtmae import VTMAE
from .vtt import VTT


class VTMAECnn(VTMAE):
    def __init__(self, encoder: VTT, *, embeddings_use_transformer: bool = False, **kwargs):
        kwargs.setdefault("early_conv_masking", True)
        super().__init__(encoder, **kwargs)
        if not self.early_conv_masking:
            raise ValueError("VTMAECnn needs early_conv_masking=True")
        self.embeddings_use_transformer = embeddings_use_transformer
        self.early_conv_tactile_towers = nn.ModuleList(
            [EarlyCNN(encoder.stacked_tactile_channels, encoder.config.dim, kind="tactile", dtype=self.dtype)
             for _ in range(encoder.config.num_tactiles)]
        )

    def _tower_tokens(self, x: dict) -> torch.Tensor:
        return torch.cat([tower(x[f"tactile{i + 1}"].to(self.dtype)) for i, tower in enumerate(self.early_conv_tactile_towers)], dim=1)

    def _tokens(self, x: dict, use_vision: bool, use_tactile: bool, image_patches, tactile_patches) -> torch.Tensor:
        c = self.config
        mod_emb = self.encoder_modality_embedding.weight
        parts = []
        if use_vision:
            img_tok = self.early_conv_vision(x["image"].to(self.dtype))
            if self.use_sincosmod_encodings:
                img_tok = img_tok + mod_emb[0]
                img_tok = img_tok + self.img_pos_enc.to(img_tok.dtype)
            parts.append(img_tok)
        if c.num_tactiles > 0 and use_tactile:
            tac_tok = self._tower_tokens(x)
            if self.use_sincosmod_encodings:
                mod = mod_emb[1 : 1 + c.num_tactiles].repeat_interleave(c.num_tactile_patches_per_sensor, dim=0)
                tac_tok = tac_tok + mod[None].to(tac_tok.dtype) + self.tac_pos_enc.to(tac_tok.dtype)
            parts.append(tac_tok)
        tokens = torch.cat(parts, dim=1)
        if not self.use_sincosmod_encodings:
            tokens = tokens + self.encoder.pos_embedding[:, 1 : tokens.shape[1] + 1].to(tokens.dtype)
        return tokens

    def get_embeddings(self, x: dict, use_vision: bool = True, use_tactile: bool = True) -> torch.Tensor:
        """The raw conv tokens, with no positional or modality embedding."""
        if "image" not in x:
            use_vision = False
        parts = []
        if use_vision:
            parts.append(self.early_conv_vision(x["image"].to(self.dtype)))
        if self.config.num_tactiles > 0 and use_tactile:
            parts.append(self._tower_tokens(x))
        tokens = torch.cat(parts, dim=1)
        if self.embeddings_use_transformer:
            tokens = self.encoder.transformer(tokens)
        return tokens
