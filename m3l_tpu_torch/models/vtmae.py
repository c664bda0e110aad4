"""VTMAE — multimodal masked autoencoder over a VTT encoder (counterpart of ``m3l_tpu/models/vtmae.py``).

The constructor builds every submodule and parameter of the JAX module (EarlyCNN towers,
decoder, mask token, pixel/tactile heads, embeddings), so JAX weights carry over whole. Ported:
the unmasked path (:meth:`get_embeddings`) and the masked-reconstruction loss. The JAX
``__call__`` draws its mask inside the loss; here :meth:`forward` draws it with
:meth:`sample_mask` from a ``torch.Generator`` and hands it to :meth:`masked_loss`, which tests
call with an injected :class:`ModalMask`. :meth:`reconstruct` gives the visualisation's
reconstructions under a mask drawn at its own counts per modality (:meth:`reconstruct_counts`).

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
from ..ops.masking import ModalMask, gather_tokens, random_modal_masking, restore_tokens
from ..ops.patches import unpatchify
from ..ops.posenc import sincos_2d
from .vtt import VTT


def _segment_count(idx: torch.Tensor, lo: int, hi: int) -> int:
    """How many indices of one row of ``idx`` lie in [lo, hi) (every row has the same count)."""
    return int(((idx[0] >= lo) & (idx[0] < hi)).sum())


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

    def _mask_counts(self, use_vision: bool, use_tactile: bool):
        """Reference mask-count split: ``int(ratio * N)`` masked tokens, the image gets
        ``int(masked * N_img / N)`` and each tactile sensor an equal share of the rest."""
        c = self.config
        n_img = c.num_image_patches if use_vision else 0
        n_tac_single = c.num_tactile_patches_per_sensor if (c.num_tactiles > 0 and use_tactile) else 0
        n_tac = n_tac_single * c.num_tactiles if n_tac_single else 0
        n = n_img + n_tac
        num_masked = int(self.masking_ratio * n)
        m_img = int(num_masked * (n_img / n)) if n else 0
        m_tac = (num_masked - m_img) // c.num_tactiles if n_tac else 0
        sizes = ([n_img] if n_img else []) + [n_tac_single] * (c.num_tactiles if n_tac else 0)
        masked = ([m_img] if n_img else []) + [m_tac] * (c.num_tactiles if n_tac else 0)
        return sizes, masked, n_img, n_tac

    def _decoder_modpos(self, tokens: torch.Tensor, use_vision: bool, use_tactile: bool) -> torch.Tensor:
        """Add the decoder modality + sin/cos positional embeddings (restored order), in the
        tokens' dtype."""
        c = self.config
        if not self.use_sincosmod_encodings:
            return tokens
        dt = tokens.dtype
        mod_emb = self.decoder_modality_embedding.weight
        n_img = c.num_image_patches if use_vision else 0
        parts = []
        if use_vision:
            img = tokens[:, :n_img] + mod_emb[0].to(dt)
            parts.append(img + self.img_pos_dec.to(dt))
        if c.num_tactiles > 0 and use_tactile:
            mod = mod_emb[1 : 1 + c.num_tactiles].repeat_interleave(c.num_tactile_patches_per_sensor, dim=0)
            tac = tokens[:, n_img:] + mod[None].to(dt)
            parts.append(tac + self.tac_pos_dec.to(dt))
        return torch.cat(parts, dim=1)

    def _decode(self, x: dict, mask: ModalMask, use_vision: bool, use_tactile: bool, precomputed=None):
        """Masked encode -> decode. Returns (decoded, image_patches, tactile_patches).

        ``precomputed=(tokens, image_patches, tactile_patches)`` shares one token pipeline
        between the policy features and this loss."""
        if precomputed is None:
            image_patches, tactile_patches = self._raw_patches(x, use_vision, use_tactile)
            tokens = self._tokens(x, use_vision, use_tactile, image_patches, tactile_patches)
        else:
            tokens, image_patches, tactile_patches = precomputed
        batch = tokens.shape[0]
        encoded = self.encoder.transformer(gather_tokens(tokens, mask.unmasked_idx))
        dec_tok = self.enc_to_dec(encoded) if self.enc_to_dec is not None else encoded
        mask_token = self.mask_token.to(dec_tok.dtype)

        if not self.use_sincosmod_encodings:
            combined_idx = torch.cat([mask.unmasked_idx, mask.masked_idx], dim=1)
            pos = self.decoder_pos_emb(combined_idx).to(dec_tok.dtype)
            k = dec_tok.shape[1]
            mask_block = mask_token.expand(batch, mask.masked_idx.shape[1], self.decoder_dim)
            combined = torch.cat([dec_tok + pos[:, :k], mask_block + pos[:, k:]], dim=1)
            full = gather_tokens(combined, mask.restore_idx)
        else:
            full = restore_tokens(dec_tok, mask_token, mask)

        decoded = self.decoder(self._decoder_modpos(full, use_vision, use_tactile))
        return decoded, image_patches, tactile_patches

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def sample_mask(
        self, generator: torch.Generator, batch: int, use_vision: bool = True, use_tactile: bool = True, masked=None
    ) -> ModalMask:
        """A random mask for ``batch`` samples, drawn with ``generator`` on its device: the
        reference counts of the loss, or ``masked`` tokens per modality segment (image first, then
        each sensor; :meth:`reconstruct_counts` gives the visualisation's)."""
        sizes, counts, _, _ = self._mask_counts(use_vision, use_tactile)
        return random_modal_masking(generator, batch, sizes, counts if masked is None else masked)

    def reconstruct_counts(self, mask_ratio: float | None = None, use_vision: bool = True, use_tactile: bool = True) -> list[int]:
        """Masked tokens per modality segment for :meth:`reconstruct`: ``int(ratio * N)`` of each
        modality's own N (not the loss's split of one total)."""
        c = self.config
        ratio = self.masking_ratio if mask_ratio is None else mask_ratio
        n_img = c.num_image_patches if use_vision else 0
        n_tac_single = c.num_tactile_patches_per_sensor if (c.num_tactiles > 0 and use_tactile) else 0
        m_img = int(ratio * n_img)
        m_tac = int(ratio * n_tac_single * c.num_tactiles / c.num_tactiles) if n_tac_single else 0
        return ([m_img] if n_img else []) + [m_tac] * (c.num_tactiles if n_tac_single else 0)

    def masked_loss(self, x: dict, mask: ModalMask, use_vision: bool = True, use_tactile: bool = True, precomputed=None) -> torch.Tensor:
        """Masked-reconstruction loss (f32 scalar) for the given mask: tactile x10; under early
        conv over all patches, else over the masked patches only."""
        if "image" not in x:
            use_vision = False
        _, masked, n_img, _ = self._mask_counts(use_vision, use_tactile)
        m_img = masked[0] if use_vision else 0
        decoded, image_patches, tactile_patches = self._decode(x, mask, use_vision, use_tactile, precomputed)
        with_tactile = self.config.num_tactiles > 0 and use_tactile

        def mse(pred, target):
            return ((pred.float() - target.float()) ** 2).mean()

        loss = torch.zeros((), dtype=torch.float32, device=decoded.device)
        if self.early_conv_masking:
            if with_tactile:
                loss = loss + 10.0 * mse(self.to_tactiles(decoded[:, n_img:]), tactile_patches)
            if use_vision:
                loss = loss + mse(self.to_pixels(decoded[:, :n_img]), image_patches)
        else:
            if with_tactile:
                idx = mask.masked_idx[:, m_img:]
                pred = self.to_tactiles(gather_tokens(decoded, idx))
                loss = loss + 10.0 * mse(pred, gather_tokens(tactile_patches, idx - n_img))
            if use_vision:
                idx = mask.masked_idx[:, :m_img]
                loss = loss + mse(self.to_pixels(gather_tokens(decoded, idx)), gather_tokens(image_patches, idx))
        return loss

    def forward(self, x: dict, generator: torch.Generator, use_vision: bool = True, use_tactile: bool = True) -> torch.Tensor:
        """Masked-reconstruction loss with a mask drawn from ``generator`` (on the batch's device)."""
        if "image" not in x:
            use_vision = False
        mask = self.sample_mask(generator, next(iter(x.values())).shape[0], use_vision, use_tactile)
        return self.masked_loss(x, mask, use_vision, use_tactile)

    def reconstruct(self, x: dict, mask: ModalMask, use_vision: bool = True, use_tactile: bool = True) -> dict:
        """Per-modality reconstructions for visualisation under ``mask`` (drawn with
        :meth:`sample_mask` at :meth:`reconstruct_counts`): ``image_rec`` / ``image_masked`` (B, H,
        W, C), ``tactile_rec`` / ``tactile_masked`` (B, sensors, H, W, C) and the f32 losses
        ``recon_loss_image`` / ``recon_loss_tactile``. Masked patches show 0.5 in the image and
        ``inf`` in the tactile maps; under early conv every patch is reconstructed, else the kept
        patches keep their input."""
        c = self.config
        if "image" not in x:
            use_vision = False
        with_tactile = c.num_tactiles > 0 and use_tactile
        n_img = c.num_image_patches if use_vision else 0
        decoded, image_patches, tactile_patches = self._decode(x, mask, use_vision, use_tactile)
        n_masked_img = _segment_count(mask.masked_idx, 0, n_img) if use_vision else 0
        enc = self.encoder

        def scatter_rows(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
            return base.scatter(1, idx[:, :, None].expand(-1, -1, base.shape[-1]), values)

        out: dict = {}
        if use_vision:
            midx = mask.masked_idx[:, :n_masked_img]
            pred = self.to_pixels(gather_tokens(decoded, midx)).float()
            patches = image_patches.float()
            if self.early_conv_masking:
                rec = self.to_pixels(decoded[:, :n_img]).float()
                out["recon_loss_image"] = ((rec - patches) ** 2).mean()
            else:
                out["recon_loss_image"] = ((pred - gather_tokens(patches, midx)) ** 2).mean()
                rec = scatter_rows(patches, midx, pred)
            grid = (*c.image_grid, c.image_patch_size, c.image_patch_size, enc.stacked_image_channels)
            out["image_rec"] = unpatchify(rec, *grid)
            out["image_masked"] = unpatchify(scatter_rows(patches, midx, torch.full_like(pred, 0.5)), *grid)
        if with_tactile:
            tidx = mask.masked_idx[:, n_masked_img:]
            pred = self.to_tactiles(gather_tokens(decoded, tidx)).float()
            patches = tactile_patches.float()
            tidx = tidx - n_img
            if self.early_conv_masking:
                rec = self.to_tactiles(decoded[:, n_img:]).float()
                out["recon_loss_tactile"] = ((rec - patches) ** 2).mean()
            else:
                out["recon_loss_tactile"] = ((pred - gather_tokens(patches, tidx)) ** 2).mean()
                rec = scatter_rows(patches, tidx, pred)
            masked = scatter_rows(patches, tidx, torch.full_like(pred, float("inf")))
            n_sens, per = c.num_tactiles, c.num_tactile_patches_per_sensor
            grid = (*c.tactile_grid, c.tactile_patch_size, c.tactile_patch_size, enc.stacked_tactile_channels)
            for key, value in (("tactile_rec", rec), ("tactile_masked", masked)):
                img = unpatchify(value.reshape(value.shape[0] * n_sens, per, -1), *grid)
                out[key] = img.reshape(-1, n_sens, *img.shape[1:])
        return out

    def get_embeddings(self, x: dict, use_vision: bool = True, use_tactile: bool = True) -> torch.Tensor:
        """Unmasked full-sequence encoder features (B, N, dim)."""
        if "image" not in x:
            use_vision = False
        image_patches = tactile_patches = None
        if not self.early_conv_masking:
            image_patches, tactile_patches = self._raw_patches(x, use_vision, use_tactile)
        tokens = self._tokens(x, use_vision, use_tactile, image_patches, tactile_patches)
        return self.encoder.transformer(tokens)
