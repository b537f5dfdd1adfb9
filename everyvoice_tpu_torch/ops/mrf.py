"""One whole HiFiGAN MRF stage: the CUDA kernel's wrapper and its plain version.

``mrf_stage`` computes what ``everyvoice_tpu/ops/mrf_pallas.py::fused_mrf``
computes: the mean over parallel ResBlock1 chains, each chain a run of
leaky-relu → dilated "SAME" conv → leaky-relu → conv → residual add per
dilation, with rows outside the sequence zero after every conv. A CUDA tensor
goes to the hand-written kernels in ``csrc/mrf.cu``: in bfloat16 a sequence
of tensor-core launches (a prologue, one implicit GEMM per conv position with
the chains side by side, a finish: 8 for a V1 stage), in float32 one
CUDA-core launch for the whole stage. A CPU tensor goes to
``mrf_stage_reference``. Nothing falls back from the kernels to the plain
version.

Weights use the JAX package's layout: each conv's kernel is (k·C, C) in
tap-major order (a flax (k, C_in, C_out) kernel reshaped), already
weight-norm folded. ``pack_mrf_weights`` concatenates them, and their
biases, into the two flat buffers both versions take.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_CHAINS = 4
MAX_DILATIONS = 4
BLOCKS_PER_SM = 2


def resblock1_halo(kernel_size: int, dilations) -> int:
    """One-sided receptive-field growth of a ResBlock1 chain."""
    return sum((kernel_size - 1) // 2 * (d + 1) for d in dilations)


def pack_mrf_weights(weights, biases, dtype: torch.dtype) -> tuple:
    """Flat (Σ k·C·C,) weight and (n_convs·C,) bias buffers in chain order."""
    w = torch.cat([wi.reshape(-1) for wi in weights]).to(dtype).contiguous()
    b = torch.cat([bi.reshape(-1) for bi in biases]).to(dtype).contiguous()
    return w, b


def _unpack(w_packed, b_packed, channels, kernel_sizes, dilation_sizes):
    """Per-chain lists of per-conv ((k·C, C) weight, (C,) bias)."""
    n_weights = sum(2 * len(d) * k for k, d in zip(kernel_sizes, dilation_sizes))
    n_convs = sum(2 * len(d) for d in dilation_sizes)
    if (w_packed.numel(), b_packed.numel()) != (
        n_weights * channels * channels, n_convs * channels
    ):
        raise ValueError(
            f"packed MRF weights hold {w_packed.numel()} weights and "
            f"{b_packed.numel()} biases; kernels {kernel_sizes} with "
            f"dilations {dilation_sizes} at {channels} channels need "
            f"{n_weights * channels * channels} and {n_convs * channels}"
        )
    out, w_off, b_off = [], 0, 0
    for k, dils in zip(kernel_sizes, dilation_sizes):
        convs = []
        for _ in range(2 * len(dils)):
            n = k * channels * channels
            convs.append((
                w_packed[w_off : w_off + n].reshape(k * channels, channels),
                b_packed[b_off : b_off + channels],
            ))
            w_off += n
            b_off += channels
        out.append(convs)
    return out


def mrf_stage_reference(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    b_packed: torch.Tensor,
    kernel_sizes=(3, 7, 11),
    dilation_sizes=((1, 3, 5),) * 3,
    slope: float = 0.1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same rounding points:
    conv operands in x's dtype, sums and chain state in float32."""
    dt = x.dtype
    channels = x.shape[-1]
    convs = _unpack(w_packed, b_packed, channels, kernel_sizes, dilation_sizes)

    def conv(v, weight, bias, k, d):
        # (B, C, T) float32 input; "SAME" padding for odd k.
        kern = weight.reshape(k, channels, channels).permute(2, 1, 0)
        v = F.leaky_relu(v, slope).to(dt).float()
        return F.conv1d(
            v, kern.float(), bias.float(), padding=(k - 1) // 2 * d, dilation=d
        )

    xf = x.float().transpose(1, 2)  # (B, C, T)
    total = None
    for k, dils, chain in zip(kernel_sizes, dilation_sizes, convs):
        cur = xf
        for u, d in enumerate(dils):
            y = conv(cur, *chain[2 * u], k, d)
            y = conv(y, *chain[2 * u + 1], k, 1)
            cur = cur + y
        total = cur if total is None else total + cur
    out = total / len(kernel_sizes)
    return out.transpose(1, 2).to(dt).contiguous()


def _plan(batch: int, length: int, channels: int, n_sm: int) -> tuple:
    """(time tile, grid) of the float32 kernel: the largest tile up to 64k
    floats a row-slab that still gives every resident block a work item, and
    a persistent grid."""
    cap = max(128, 65536 // channels)
    tile = 128
    for cand in (2048, 1024, 512, 256):
        if cand <= cap and batch * -(-length // cand) >= BLOCKS_PER_SM * n_sm:
            tile = cand
            break
    items = batch * -(-length // tile)
    return tile, min(items, BLOCKS_PER_SM * n_sm)


def _check(x, w_packed, b_packed, kernel_sizes, dilation_sizes):
    if x.dim() != 3:
        raise ValueError(f"mrf_stage takes x of shape (B, T, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mrf_stage takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("weights", w_packed), ("biases", b_packed)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"mrf_stage {name} are {t.dtype} on {t.device}; x is "
                f"{x.dtype} on {x.device}"
            )
        if t.dim() != 1:
            raise ValueError(f"mrf_stage takes packed 1-D {name}")
    if len(kernel_sizes) != len(dilation_sizes):
        raise ValueError("one dilation list per kernel size is required")


def mrf_stage(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    b_packed: torch.Tensor,
    kernel_sizes=(3, 7, 11),
    dilation_sizes=((1, 3, 5),) * 3,
    slope: float = 0.1,
) -> torch.Tensor:
    """One MRF stage of (B, T, C) ``x``: the CUDA kernels for a CUDA tensor,
    the plain version for a CPU tensor. ``mrf_stage.launches`` counts the
    stages run on the card, ``mrf_stage.kernel_launches`` the kernel
    launches they issued."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilation_sizes = tuple(tuple(int(d) for d in ds) for ds in dilation_sizes)
    _check(x, w_packed, b_packed, kernel_sizes, dilation_sizes)
    if x.device.type == "cpu":
        return mrf_stage_reference(
            x, w_packed, b_packed, kernel_sizes, dilation_sizes, slope
        )
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage runs on cuda or cpu, not {x.device}")
    b, t, c = x.shape
    _unpack(w_packed, b_packed, c, kernel_sizes, dilation_sizes)  # sizes
    if c % 32 != 0:
        raise ValueError(f"the MRF kernel takes a multiple of 32 channels, got {c}")
    if len(kernel_sizes) > MAX_CHAINS or any(
        k % 2 == 0 or not 1 <= len(ds) <= MAX_DILATIONS
        for k, ds in zip(kernel_sizes, dilation_sizes)
    ):
        raise ValueError(
            f"the MRF kernel takes up to {MAX_CHAINS} chains of odd kernel "
            f"size with 1..{MAX_DILATIONS} dilations, got {kernel_sizes} "
            f"{dilation_sizes}"
        )
    if not (x.is_contiguous() and w_packed.is_contiguous() and b_packed.is_contiguous()):
        raise ValueError("mrf_stage takes contiguous tensors")
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("mrf_stage takes x and weights that start 16-byte aligned")

    from everyvoice_tpu_torch.ops import _build

    lib = _build.load("mrf")
    n = len(kernel_sizes)
    ks = (ctypes.c_int * n)(*kernel_sizes)
    nd = (ctypes.c_int * n)(*(len(ds) for ds in dilation_sizes))
    dl = (ctypes.c_int * (n * MAX_DILATIONS))(
        *(d for ds in dilation_sizes for d in (*ds, *(0,) * (MAX_DILATIONS - len(ds))))
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        # Per chain: the float32 state (updated in place by the kernels) and
        # the two bf16 activations the convs read.
        cur = torch.empty(n, b, t, c, dtype=torch.float32, device=x.device)
        act = torch.empty(n, b, t, c, dtype=torch.bfloat16, device=x.device)
        yact = torch.empty_like(act)
        issued = ctypes.c_int(0)
        fn = lib.mrf_stage_bf16_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        rc = fn(
            x.data_ptr(), out.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(),
            cur.data_ptr(), act.data_ptr(), yact.data_ptr(), b, t, c,
            n, ks, nd, dl, float(slope), stream, ctypes.byref(issued),
        )
        mrf_stage.kernel_launches += issued.value
    else:
        halo = max(resblock1_halo(k, ds) for k, ds in zip(kernel_sizes, dilation_sizes))
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        tile, grid = _plan(b, t, c, n_sm)
        window = tile + 2 * halo
        scratch = torch.empty(
            grid * (2 * window + tile) * c, dtype=torch.float32, device=x.device
        )
        fn = lib.mrf_stage_f32_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        rc = fn(
            x.data_ptr(), out.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(),
            scratch.data_ptr(), b, t, c, tile, halo, grid,
            n, ks, nd, dl, float(slope), stream,
        )
        if rc == 0:
            mrf_stage.kernel_launches += 1
    if rc != 0:
        raise RuntimeError(f"mrf_stage kernel launch failed: CUDA error {rc}")
    mrf_stage.launches += 1
    return out


mrf_stage.launches = 0
mrf_stage.kernel_launches = 0
