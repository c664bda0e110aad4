"""VTMAE — multimodal masked autoencoder over a VTT encoder (counterpart of ``m3l_tpu/models/vtmae.py``).

The constructor builds every submodule and parameter of the JAX module (EarlyCNN towers,
decoder, mask token, pixel/tactile heads, embeddings), so JAX weights carry over whole. This
serving slice implements the unmasked path: :meth:`get_embeddings` and the token pipeline it
uses. The masked loss, the decode path and ``reconstruct`` come with the training slice.

The sin/cos tables are buffers recomputed from the config, not parameters. Mixed dtypes follow
JAX's promotion: image tokens plus the f32 modality embedding become f32, tactile tokens stay
in the compute dtype, and their concatenation is f32 (torch promotes as jnp does).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.early_cnn import EarlyCNN
from ..nn.layers import Linear
from ..nn.transformer import Transformer
from ..ops.posenc import sincos_2d
from .vtt import VTT


class VTMAE(nn.Module):
    def __init__(
        self,
        encoder: VTT,
        *,
        decoder_dim: int,
        masking_ratio: float = 0.75,
        decoder_depth: int = 1,
        decoder_heads: int = 8,
        decoder_dim_head: int = 64,
        early_conv_masking: bool = False,
        use_sincosmod_encodings: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        if not 0.0 < masking_ratio < 1.0:
            raise ValueError(f"masking ratio must be in (0, 1), got {masking_ratio}")
        c = encoder.config
        self.encoder = encoder
        self.config = c
        self.dtype = dtype
        self.masking_ratio = masking_ratio
        self.early_conv_masking = early_conv_masking
        self.use_sincosmod_encodings = use_sincosmod_encodings
        self.decoder_dim = decoder_dim
        enc_dim = c.dim

        if early_conv_masking:
            self.early_conv_vision = EarlyCNN(encoder.stacked_image_channels, enc_dim, kind="image", dtype=dtype)
            self.early_conv_tactile = EarlyCNN(encoder.stacked_tactile_channels, enc_dim, kind="tactile", dtype=dtype)

        self.enc_to_dec = Linear(enc_dim, decoder_dim, dtype=dtype) if enc_dim != decoder_dim else None
        self.mask_token = nn.Parameter(torch.randn(decoder_dim))
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads, decoder_dim_head, decoder_dim * 4, dtype=dtype)
        self.decoder_pos_emb = nn.Embedding(c.num_patches, decoder_dim)
        self.to_pixels = Linear(decoder_dim, c.image_patch_dim * c.frame_stack, dtype=dtype)
        self.to_tactiles = Linear(decoder_dim, c.tactile_patch_dim * c.frame_stack, dtype=dtype)

        # modality embeddings: row 0 = image, rows 1..num_tactiles = sensors
        self.encoder_modality_embedding = nn.Embedding(1 + c.num_tactiles, enc_dim)
        self.decoder_modality_embedding = nn.Embedding(1 + c.num_tactiles, decoder_dim)

        igh, igw = c.image_grid
        tgh, tgw = c.tactile_grid

        def table(h: int, w: int, d: int, reps: int = 1) -> torch.Tensor:
            return torch.from_numpy(sincos_2d(h, w, d)).repeat(reps, 1)[None]

        self.register_buffer("img_pos_enc", table(igh, igw, enc_dim), persistent=False)  # (1, N_img, D)
        self.register_buffer("img_pos_dec", table(igh, igw, decoder_dim), persistent=False)
        if c.num_tactiles:
            self.register_buffer("tac_pos_enc", table(tgh, tgw, enc_dim, c.num_tactiles), persistent=False)  # (1, N_tac, D)
            self.register_buffer("tac_pos_dec", table(tgh, tgw, decoder_dim, c.num_tactiles), persistent=False)

    # ------------------------------------------------------------------ #
    # token construction
    # ------------------------------------------------------------------ #

    def _tactile_inputs(self, x: dict) -> list[torch.Tensor]:
        return [x[f"tactile{i + 1}"] for i in range(self.config.num_tactiles)]

    def _raw_patches(self, x: dict, use_vision: bool, use_tactile: bool):
        """Per-modality raw pixel patches (the patch-embedding inputs and loss targets)."""
        c = self.config
        image_patches = self.encoder.image_embed.to_patches(x["image"]) if use_vision else None
        tactile_patches = None
        if c.num_tactiles > 0 and use_tactile:
            tactile_patches = torch.cat([self.encoder.tactile_embed.to_patches(t) for t in self._tactile_inputs(x)], dim=1)
        return image_patches, tactile_patches

    def _tokens(self, x: dict, use_vision: bool, use_tactile: bool, image_patches, tactile_patches) -> torch.Tensor:
        """Embed + add modality/positional encodings; concat modalities."""
        c = self.config
        mod_emb = self.encoder_modality_embedding.weight
        parts = []
        if use_vision:
            if self.early_conv_masking:
                img_tok = self.early_conv_vision(x["image"].to(self.dtype))
                if img_tok.shape[1] != c.num_image_patches:
                    raise ValueError(
                        f"early-conv token grid ({img_tok.shape[1]}) must match the patch grid ({c.num_image_patches})"
                    )
            else:
                img_tok = self.encoder.image_embed(image_patches.to(self.dtype))
            if self.use_sincosmod_encodings:
                img_tok = img_tok + mod_emb[0]
                img_tok = img_tok + self.img_pos_enc.to(img_tok.dtype)
            parts.append(img_tok)
        if c.num_tactiles > 0 and use_tactile:
            if self.early_conv_masking:
                tac_tok = torch.cat([self.early_conv_tactile(t.to(self.dtype)) for t in self._tactile_inputs(x)], dim=1)
            else:
                tac_tok = self.encoder.tactile_embed(tactile_patches.to(self.dtype))
            if self.use_sincosmod_encodings:
                nt = c.num_tactile_patches_per_sensor
                mod = mod_emb[1 : 1 + c.num_tactiles].repeat_interleave(nt, dim=0)  # (N_tac, D)
                tac_tok = tac_tok + mod[None].to(tac_tok.dtype)
                tac_tok = tac_tok + self.tac_pos_enc.to(tac_tok.dtype)
            parts.append(tac_tok)
        tokens = torch.cat(parts, dim=1)
        if not self.use_sincosmod_encodings:
            n = tokens.shape[1]
            tokens = tokens + self.encoder.pos_embedding[:, 1 : n + 1].to(tokens.dtype)
        return tokens

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def get_embeddings(self, x: dict, use_vision: bool = True, use_tactile: bool = True) -> torch.Tensor:
        """Unmasked full-sequence encoder features (B, N, dim)."""
        if "image" not in x:
            use_vision = False
        image_patches = tactile_patches = None
        if not self.early_conv_masking:
            image_patches, tactile_patches = self._raw_patches(x, use_vision, use_tactile)
        tokens = self._tokens(x, use_vision, use_tactile, image_patches, tactile_patches)
        return self.encoder.transformer(tokens)
