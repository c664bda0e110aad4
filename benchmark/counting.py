"""Operations and bytes of the work a cell does, counted from shapes, and the card's peaks.

The counts describe the algorithm, not the kernel that runs it, so a faster implementation of
the same work reads a higher share and no correct one can read over 100%:

* a roofline time is max(bytes / peak bytes per second, operations / peak operations per second),
  with the card's fastest dense rate (bf16) for every dtype;
* bytes count each input read once and each output written once;
* attention takes 4 B H Nq Nk Dh operations forward (its two products) and 2.5 times that
  backward, over the kept keys only where a key mask applies;
* model operations count forward plus backward (3x forward where gradients flow), once, with no
  recomputation.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}  # the profiler's names of the operators' dtypes


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def attention_fwd_flops(rows: int, queries: int, kept_keys_per_row: float, inner: int) -> float:
    """Both products of attention over ``rows`` sequences; ``inner`` = heads x head size."""
    return 4.0 * rows * queries * kept_keys_per_row * inner


def attention_fwd_bytes(rows: int, n: int, inner: int, elem: int, bias: bool) -> float:
    """Packed qkv and the f32 key bias read, the output written."""
    return rows * n * (3 * inner * elem + inner * elem + (4 if bias else 0))


def attention_bwd_bytes(rows: int, n: int, inner: int, elem: int, bias: bool) -> float:
    """Packed qkv, the output's gradient and the f32 key bias read, the packed gradient written."""
    return rows * n * (3 * inner * elem + inner * elem + 3 * inner * elem + (4 if bias else 0))


def attention_roofline_s(rows: int, n: int, inner: int, elem: int, kept_keys_per_row: float | None, backward: bool) -> float:
    kept = n if kept_keys_per_row is None else kept_keys_per_row
    bias = kept_keys_per_row is not None
    flops = attention_fwd_flops(rows, n, kept, inner) * (2.5 if backward else 1.0)
    nbytes = (attention_bwd_bytes if backward else attention_fwd_bytes)(rows, n, inner, elem, bias)
    return roofline_s(flops, nbytes)


# ------------------------------------------------------------------------------------------ #
# model operations, per sample
# ------------------------------------------------------------------------------------------ #
def linear_flops(tokens: float, d_in: int, d_out: int) -> float:
    return 2.0 * tokens * d_in * d_out


def conv_flops(out_hw: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * out_hw * c_in * c_out * k * k


def block_flops(tokens: int, dim: int, inner: int, mlp: int, kept_keys: float | None = None) -> float:
    """One pre-norm transformer block over ``tokens`` tokens: qkv, attention, output
    projection and the two MLP layers (norms and activations are not counted)."""
    keys = tokens if kept_keys is None else kept_keys
    return (linear_flops(tokens, dim, 3 * inner) + attention_fwd_flops(1, tokens, keys, inner)
            + linear_flops(tokens, inner, dim) + linear_flops(tokens, dim, mlp) + linear_flops(tokens, mlp, dim))


def vtt_flops(cfg: dict) -> dict[str, float]:
    """Forward operations per sample of the M3L policy: ``policy`` (tokenizers, the encoder over
    every token, the post layer, the heads) and ``mae`` (the encoder over the kept tokens, the
    decoder over every token, the patch heads)."""
    d, fs = cfg["dim_embedding"], cfg["frame_stack"]
    inner = cfg["heads"] * cfg["dim_head"]
    g_img, g_tac = cfg["image_size"] // 8, cfg["tactile_size"] // 4
    n_img, n_tac = g_img * g_img, g_tac * g_tac
    n = n_img + 2 * n_tac

    def tower(size, last_k, last_stride, c_in):
        hw, total = size, 0.0
        widths = [c_in, d // 8, d // 4, d // 2]
        for i, (k, s) in enumerate([(4, 2), (4, 2), (last_k, last_stride)]):
            hw //= s
            total += conv_flops(hw * hw, widths[i], widths[i + 1], k)
        return total + conv_flops(hw * hw, d // 2, d, 1)

    tokenizers = tower(cfg["image_size"], 4, 2, 3 * fs) + 2 * tower(cfg["tactile_size"], 3, 1, 3 * fs)
    encoder = cfg["depth"] * block_flops(n, d, inner, cfg["mlp_dim"])
    post = block_flops(n, d, inner, 2 * d)
    heads = 2 * (linear_flops(1, d, 256) + linear_flops(1, 256, 256)) + linear_flops(1, 256, cfg["action_dim"]) + linear_flops(1, 256, 1)
    masked = sum(_mask_counts(cfg))
    kept = n - masked
    mae_enc = cfg["depth"] * block_flops(kept, d, inner, cfg["mlp_dim"])
    dec_inner = cfg["decoder_heads"] * cfg["dim_head"]
    decoder = cfg["decoder_depth"] * block_flops(n, d, dec_inner, 4 * d)
    patch_heads = linear_flops(n_img, d, 64 * 3 * fs) + linear_flops(2 * n_tac, d, 16 * 3 * fs)
    return {"policy": tokenizers + encoder + post + heads, "mae": mae_enc + decoder + patch_heads}


def _mask_counts(cfg: dict) -> list[int]:
    n_img, n_tac = (cfg["image_size"] // 8) ** 2, (cfg["tactile_size"] // 4) ** 2
    n = n_img + 2 * n_tac
    masked = int(cfg["masking_ratio"] * n)
    m_img = int(masked * n_img / n)
    return [m_img, (masked - m_img) // 2, (masked - m_img) // 2]


def vit_step_flops(cfg: dict, task: str, batch: int, kept: dict | None = None) -> float:
    """Model operations of one step of the SSL Trainer on the ViT: ``dino`` (the student's global
    and local passes, heads and backward; the teacher's global pass and the probe's full pass;
    the reconstruction probe with its backward) or ``force`` (the frozen encoder's pass, the
    pooler probe with its backward). ``kept``: the mean kept keys per row of the global and the
    local passes (every key without it)."""
    p, d = cfg["patch_size"], cfg["embed_dim"]
    n = (cfg["img_size"] // p) ** 2
    tok = n + cfg["num_register_tokens"]
    mlp = int(d * cfg["mlp_ratio"])
    patch = 2.0 * n * cfg["in_chans"] * p * p * d
    kept = kept or {}

    def encoder(keys=None):
        return cfg["depth"] * block_flops(tok, d, d, mlp, keys)

    if task == "dino":
        hid, bott, k_out = cfg["dino_hidden_dim"], cfg["dino_bottleneck_dim"], cfg["dino_out_dim"]
        head = linear_flops(1, d, hid) + linear_flops(1, hid, hid) + linear_flops(1, hid, bott) + linear_flops(1, bott, k_out)
        mg, ml = cfg["num_global_masks"], cfg["num_local_masks"]
        kg, kl = kept.get("global"), kept.get("local")
        student = 2 * patch + mg * (encoder(kg) + head) + ml * (encoder(kl) + head)
        teacher = patch + mg * (encoder(kg) + head)
        e = cfg["recon_probe_embed_dim"]
        recon = (linear_flops(n, d, e) + cfg["recon_probe_depth"] * block_flops(n, e, e, 4 * e)
                 + linear_flops(n, e, p * p * cfg["in_chans"]))
        return batch * (3 * student + teacher + patch + encoder() + 3 * recon)
    pool = (linear_flops(1, d, d) + linear_flops(n, d, 2 * d) + attention_fwd_flops(1, 1, n, d) + linear_flops(1, d, d)
            + linear_flops(1, d, mlp) + linear_flops(1, mlp, d) + linear_flops(1, d, d // 4) + linear_flops(1, d // 4, 3))
    return batch * (patch + encoder() + 3 * pool)
