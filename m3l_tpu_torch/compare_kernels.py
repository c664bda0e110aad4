"""This tree's packed attention kernels against another checkout's, on the card: results,
registers and spills, and times taken in turns in one process.

    python -m m3l_tpu_torch.compare_kernels <other checkout>/m3l_tpu_torch/csrc

The other tree's ``flash_attention_qkv_fwd.cu`` and ``flash_attention_qkv_bwd.cu`` (their
``m3l_flash_qkv_fwd`` and ``m3l_flash_qkv_bwd`` must take this tree's arguments) are built with
this tree's nvcc flags into ``kernels/_build/other/``. Both trees' kernels are called the same
way, straight through those C entry points on preallocated outputs (the backward's f32 scratch
sized for either tree), so a time is the kernel's and not the wrapper's.

* At the shapes ``chip_smoke.py`` checks and a few more (``SHAPES``, with and without a key
  mask), the bf16 bodies, which both trees share, must give every output (forward and backward)
  bitwise equal to the other tree's.
* ``MOVED``: the dtypes whose body differs between the trees (f32: the other tree's CUDA-core
  bodies, this tree's 3xTF32 bodies). Both trees' forward and backward are held at every shape
  to the plain versions' bounds, ``flash_attention_qkv_tolerance`` and
  ``flash_attention_qkv_bwd_tolerance``, and max err/tol is printed.

Registers, stack and spills of every kernel of both trees are printed (``ptxas -v``); this tree's
bodies are ``fwd_mma_kernel<KD>``, ``bwd_mma_kernel<KD>`` (bf16), ``fwd_tf32_kernel<KD>`` and
``bwd_tf32_kernel<KD>`` (f32) for a head dim padded to 16 * KD.

``BLOCK_SHAPES``: the moved backward under a block key mask as DINO's global view draws it (the
register key and one block of the 14 x 14 patch grid, 6 to ~120 of 197 keys), where a few kept
keys take all the attention and dK and dV grow large: both trees' err/tol, and the largest error
of dQ, dK and dV of each tree and of the plain version against the same function in float64.

Times are CUDA-event means in the order other, this, this, other, so drift of the card shows:
bf16 at B=512, N=192 and 10, H=4, Dh=64; the moved dtype at ``TIMED_MOVED``. Exits 1 if a shared
body's output differs or a moved one leaves its bound.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from .kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build_all, find_nvcc, load_library
from .nn import flash_attention as fa
from .ssl.masks import sample_block_masks, sample_block_masks_constrained

NAMES = {"flash_attention_qkv_fwd": fa._SIGNATURES, "flash_attention_qkv_bwd": fa._BWD_SIGNATURES}
ENTRY = {"flash_attention_qkv_fwd": "m3l_flash_qkv_fwd", "flash_attention_qkv_bwd": "m3l_flash_qkv_bwd"}
SHAPES = [(512, 192, 4, 64), (512, 10, 4, 64), (8, 192, 4, 64), (64, 196, 16, 64), (3, 1, 2, 8), (2, 33, 2, 128),
          (64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (2, 784, 4, 64), (2, 417, 2, 64), (2, 209, 2, 128),
          (64, 197, 6, 64), (64, 392, 12, 32)]
MOVED = (torch.float32,)  # the dtypes whose body differs between the trees
# the moved bodies timed in turns: the SSL slices' shapes, the training shape and a long head
BLOCK_SHAPES = [(64, 197, 6, 64)]
TIMED_MOVED = [(64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (512, 192, 4, 64), (2, 784, 4, 64), (64, 197, 6, 64),
               (256, 197, 6, 64), (64, 392, 12, 32)]


def registers(nvcc: str, src: Path) -> list[str]:
    """``ptxas -v`` lines: each kernel's name, its stack and spills, and its registers."""
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", "/dev/null", str(src)]
    err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr.splitlines()
    out, kernel, spills = [], None, ""
    for line in err:
        if "Compiling entry function" in line:
            kernel, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            out.append(f"{kernel}: {spills}; {line.split(':', 1)[1].strip()}")
    return out


def load_other(csrc: Path) -> dict[str, ctypes.CDLL]:
    nvcc = find_nvcc()
    out_dir = BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, sigs in NAMES.items():
        lib_path = out_dir / f"{name}.so"
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib_path), str(csrc / f"{name}.cu")], check=True)
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, ENTRY[name])  # the other tree may lack this tree's other entry points
        fn.argtypes, fn.restype = sigs[ENTRY[name]]
        libs[name] = lib
        for tree, src in (("other", csrc / f"{name}.cu"), ("this", CSRC_DIR / f"{name}.cu")):
            for line in registers(nvcc, src):
                print(f"  {tree} {line}")
    return libs


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_keep(b: int, seed: int) -> torch.Tensor:
    """(B, 197) DINO global-view keep-masks: the register key and one block avoiding four local ones."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    local = sample_block_masks(g, b, (14, 14), (0.2, 0.8), 4)
    glob = sample_block_masks_constrained(g, b, (14, 14), (0.2, 0.8), 1, local.any(0), 4)[0]
    return torch.cat([torch.ones(b, 1, dtype=torch.bool, device="cuda"), glob], dim=1)


def bwd_f64(qkv, g, h, bias, scale) -> torch.Tensor:
    """The packed dqkv of the function in float64."""
    q, k, v = (x.double() for x in fa._split_heads(qkv.double(), h, 3))
    go = fa._split_heads(g.double(), h, 1)[0].double()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
    a = torch.softmax(s, dim=-1)
    da = torch.matmul(go, v.transpose(-1, -2))
    ds = a * (da - (da * a).sum(-1, keepdim=True)) * scale
    return torch.cat([fa._merge_heads(x) for x in (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), torch.matmul(a.transpose(-1, -2), go))], -1)


def calls(libs, b, n, h, dh, dtype, masked, seed=0):
    """The forward and backward of the libraries ``libs`` as argument-free launches on seeded
    inputs, each writing its own preallocated output: both trees are called the same way. The
    third function gives the max err/tol of a forward and a backward output against the plain
    versions. ``masked``: False, True (a random key mask, 0.7 kept) or "block" (``block_keep``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device="cuda").to(dtype)
    cot = torch.randn(b, n, h * dh, generator=g, device="cuda").to(dtype)
    bias = None
    if masked == "block":
        bias = fa._key_bias(block_keep(b, seed)).contiguous()
    elif masked:
        keep = torch.rand(b, n, generator=g, device="cuda") > 0.3
        keep[:, 0] = True
        bias = fa._key_bias(keep).contiguous()
    scale, elem = dh**-0.5, qkv.element_size()
    out_f, out_b = torch.empty(b, n, h * dh, device="cuda", dtype=dtype), torch.empty_like(qkv)
    # f32 scratch for either tree: (m, l, D) a query, or (m, 1 / l, D, 0) a query padded to 16
    stats = torch.empty((b, h, (n + 15) // 16 * 16, 4), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bp = None if bias is None else bias.data_ptr()

    def fwd():
        if libs["flash_attention_qkv_fwd"].m3l_flash_qkv_fwd(qkv.data_ptr(), bp, out_f.data_ptr(), b, n, h, dh, scale, elem, stream):
            raise RuntimeError("forward launch failed")
        return out_f

    def bwd():
        if libs["flash_attention_qkv_bwd"].m3l_flash_qkv_bwd(
            qkv.data_ptr(), bp, cot.data_ptr(), out_b.data_ptr(), stats.data_ptr(), b, n, h, dh, scale, elem, stream
        ):
            raise RuntimeError("backward launch failed")
        return out_b

    bwd.inputs = (qkv, cot, h, bias, scale)

    def err_over_tol(out_fwd, out_bwd):
        mask = None if bias is None else bias == 0
        ref = fa.flash_attention_qkv_reference(qkv, h, key_mask=mask)
        tol = fa.flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
        fwd_r = ((out_fwd.float() - ref.float()).abs() / tol).max().item()
        ref = fa.flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
        tol = fa.flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
        return fwd_r, ((out_bwd.float() - ref.float()).abs() / tol).max().item()

    return fwd, bwd, err_over_tol


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    build_all()
    other = load_other(Path(args[0]))
    this = {name: load_library(name, sigs) for name, sigs in NAMES.items()}
    same = True
    for b, n, h, dh in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                (this_f, this_b, ratio), (other_f, other_b, _) = (calls(libs, b, n, h, dh, dtype, masked) for libs in (this, other))
                if dtype in MOVED:
                    (tf, tb), (of, ob) = ratio(this_f(), this_b()), ratio(other_f(), other_b())
                    ok = max(tf, tb, of, ob) <= 1.0
                    line = (f"max err/tol forward this {tf:.3f}, other {of:.3f}; backward this {tb:.3f}, other {ob:.3f}"
                            f"{'' if ok else ' OUT OF BOUND'}")
                else:
                    fwd_ok, bwd_ok = torch.equal(this_f(), other_f()), torch.equal(this_b(), other_b())
                    ok = fwd_ok and bwd_ok
                    line = f"forward {'bit-equal' if fwd_ok else 'DIFFERENT'}, backward {'bit-equal' if bwd_ok else 'DIFFERENT'}"
                same &= ok
                print(f"  B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]} mask={masked}: {line}")
    for b, n, h, dh in BLOCK_SHAPES:
        for dtype in MOVED:
            (this_f, this_b, ratio), (other_f, other_b, _) = (calls(libs, b, n, h, dh, dtype, "block") for libs in (this, other))
            (_, tb), (_, ob) = ratio(this_f(), this_b()), ratio(other_f(), other_b())
            qkv, cot, _, bias, scale = this_b.inputs
            truth = bwd_f64(*this_b.inputs)
            plain = fa.flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=bias == 0)
            errs = {tree: [(out[..., i * h * dh:(i + 1) * h * dh].double() - truth[..., i * h * dh:(i + 1) * h * dh]).abs().max().item()
                           for i in range(3)] for tree, out in (("this", this_b()), ("other", other_b()), ("plain", plain))}
            same &= tb <= 1.0  # this tree's; the other's is shown
            print(f"  block mask B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]} backward: max err/tol this {tb:.3f}, other {ob:.3f}; "
                  f"max |dq|, |dk|, |dv| {[round(x.abs().max().item(), 3) for x in truth.split(h * dh, -1)]}; against float64 (dq, dk, dv): "
                  + "; ".join(f"{tree} " + ", ".join(f"{e:.3e}" for e in v) for tree, v in errs.items())
                  + ("" if tb <= 1.0 else " OUT OF BOUND") + ("" if ob <= 1.0 else " (the other tree out of bound)"))
    timed = [(512, n, 4, 64, torch.bfloat16) for n in (192, 10)] + [(*shape, dt) for shape in TIMED_MOVED for dt in MOVED]
    for b, n, h, dh, dtype in timed:
        (this_f, this_b, _), (other_f, other_b, _) = (calls(libs, b, n, h, dh, dtype, False, seed=101) for libs in (this, other))
        for kind, mine, theirs in (("forward", this_f, other_f), ("backward", this_b, other_b)):
            turns = [("other", cuda_ms(theirs)), ("this", cuda_ms(mine)), ("this", cuda_ms(mine)), ("other", cuda_ms(theirs))]
            print(f"  B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]} {kind} ms: " + ", ".join(f"{tree} {ms:.4f}" for tree, ms in turns))
    print("shared bodies bit-equal, moved ones within bound" if same else "SOME OUTPUTS DIFFER OR LEAVE THEIR BOUND")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
