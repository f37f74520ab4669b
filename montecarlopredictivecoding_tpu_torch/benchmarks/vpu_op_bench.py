"""Per-op cost probe of the chain kernel's elementwise paths, on the card.

The counterpart of the JAX package's ``benchmarks/vpu_op_bench.py``.  Each
variant is one elementwise step, ``x <- f(x)``, run T times on every element
of a ``[B, 384]`` f32 tile that starts at 0.3; its cost is the marginal time
a step between two T values (min of N calls each), so the launch and the
write-back cancel.  It says what each transcendental, the counter-hash draw
and the Box-Muller pair cost on the CUDA cores, and whether the two choices
the JAX package made on the TPU's numbers pay on Hopper: the polynomial
``sincos_2pi`` instead of the library's sin/cos (``bm_poly`` against
``bm_hw``) and sigmoid through tanh (``sigmoid_tanh`` against ``sigmoid``).

``run_variant`` launches the kernel of ``ops/csrc/op_probe.cu`` on CUDA
tensors and raises where there is no card; on the CPU it runs the plain
PyTorch version (``make_variant`` iterated, ``run_variant_reference``).
Both start from 0.3, as the JAX probe, or from a tile handed in
(``signed_start``: the holds' signed start).  ``run_variant.launches`` and
``device_sincos_2pi.launches`` count the two kernels' launches.

The draws differ from the TPU probe's by design: the TPU's on-core PRNG
(``pltpu.prng_seed``, ``prng_random_bits``) has no CUDA counterpart, so
both versions here draw the port's counter hash (``ops.mcpc_chain``'s
``counter_bits``, the JAX package's ``_mock_bits``): ``prng`` reads draw
``t`` at step ``t``, the Box-Muller variants draws ``2t`` and ``2t + 1``,
at element index ``row * 384 + col``.

The bound of a variant is the operations its step needs per element, by
pipe (:data:`STEP_OPS`), over the H100's rates per SM per clock at the SM
clock that ``nvidia-smi`` reads while the probe runs
(:func:`bound_us_per_step`).  A library function counts as its one MUFU
operation, so the accurate ``logf``, ``sinf`` and the rest sit well above
it.

Run (on a CUDA device; there is no CPU mode)::

    python -m montecarlopredictivecoding_tpu_torch.benchmarks.vpu_op_bench [B ...]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import math
import subprocess
import typing as tp
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import Tensor

from ..ops.mcpc_chain import _unit_from_bits, counter_bits, sincos_2pi, uniforms

# long loops, as the JAX probe's: a variant's work must dwarf a launch's
T_LO, T_HI = 100_000, 500_000
COLS = 384
# in the JAX probe's order (its main); op_probe.cu's Variant enum follows it
VARIANTS = ("baseline", "prng", "log", "sqrt", "rsqrt", "sqrt_via_rsqrt", "sin", "cos",
            "exp", "sigmoid", "tanh", "sigmoid_tanh", "bm_hw", "bm_poly")
RANDOM_VARIANTS = ("prng", "bm_hw", "bm_poly")
X0 = 0.3
# the holds start from a signed tile, uniform in [-START, START], so that
# |x| and the x < 0 side of every step run (the timed runs start at X0)
START = 3.0
# points of the sincos_2pi accuracy check, as the JAX probe's
SINCOS_POINTS = 40001
# the kernel against the plain version on the card: 1e-5 after 64 steps
# (CUDA's math library, 1-2 ulp, against PyTorch's CUDA ops, over a
# contracting map); the device sincos_2pi against the plain one: 1e-6
CARD_ATOL = 1e-5
SINCOS_ATOL = 1e-6


def card_tolerance(name: str, plain: Tensor) -> float:
    """The kernel's tolerance against the plain version's tile ``plain``:
    CARD_ATOL, scaled for the random variants by the tile's largest |x|
    where that exceeds 1.  At noise scale 1 they wander to |x| of tens,
    where an f32 ulp is some 4e-6, so an ulp that the two libraries round
    apart in one step stays in x."""
    if name not in RANDOM_VARIANTS:
        return CARD_ATOL
    return CARD_ATOL * max(1.0, float(plain.abs().max()))


def _check_name(name: str) -> int:
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; the variants are {', '.join(VARIANTS)}")
    return VARIANTS.index(name)


# ------------------------------------------------------- plain versions


def make_variant(name: str) -> tp.Callable[[int, Tensor, int, float], Tensor]:
    """The plain PyTorch version of variant ``name``: ``body(t, x, seed,
    noise_scale)`` is ``x`` after step ``t`` (the JAX probe's
    ``make_variant`` body).  ``seed`` and ``noise_scale`` matter to the
    random variants only."""
    _check_name(name)

    def bits(x: Tensor, seed: int, draw: int) -> Tensor:
        return counter_bits(x.shape, seed, draw, device=x.device)

    def body(t: int, x: Tensor, seed: int, noise_scale: float) -> Tensor:
        if name == "baseline":
            return x * 0.9999 + 1e-4
        if name == "prng":
            return x * 0.9999 + noise_scale * _unit_from_bits(bits(x, seed, t))
        if name == "log":
            return x * 0.1 + torch.log(torch.abs(x) + 1.0)
        if name == "sqrt":
            return x * 0.1 + torch.sqrt(torch.abs(x) + 1.0)
        if name == "rsqrt":
            return x * 0.1 + torch.rsqrt(torch.abs(x) + 1.0)
        if name == "sqrt_via_rsqrt":
            v = torch.abs(x) + 1.0
            return x * 0.1 + v * torch.rsqrt(v)
        if name == "sin":
            return x * 0.1 + torch.sin(x)
        if name == "cos":
            return x * 0.1 + torch.cos(x)
        if name == "exp":
            return x * 0.1 + torch.exp(-torch.abs(x))
        if name == "sigmoid":
            return x * 0.1 + 1.0 / (1.0 + torch.exp(-x))
        if name == "tanh":
            return x * 0.1 + torch.tanh(x)
        if name == "sigmoid_tanh":
            return x * 0.1 + (0.5 + 0.5 * torch.tanh(0.5 * x))
        # bm_hw, bm_poly: one Box-Muller pair from draws 2t and 2t + 1
        u1, u2 = uniforms(bits(x, seed, 2 * t), bits(x, seed, 2 * t + 1))
        r = torch.sqrt(-2.0 * torch.log(u1))
        if name == "bm_hw":
            th = (2.0 * math.pi) * u2
            c, s = torch.cos(th), torch.sin(th)
        else:
            c, s = sincos_2pi(u2)
        return x * 0.9999 + noise_scale * (r * c + r * s)

    return body


def _check_sizes(B: int, T: int) -> None:
    if B < 1 or T < 0:
        raise ValueError(f"B must be at least 1 and T at least 0, got B={B}, T={T}")
    if B * COLS >= 2**31:
        raise ValueError(f"B={B} makes more elements than the kernel indexes")


def signed_start(B: int, seed: int, device="cpu") -> Tensor:
    """A ``[B, 384]`` float32 start tile, uniform in [-START, START], made
    from ``seed`` on the CPU and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((B, COLS), generator=gen, dtype=torch.float32) * 2.0 - 1.0) * START
    return x.to(device)


def _start(B: int, device, x0: tp.Optional[Tensor]) -> Tensor:
    """The start tile: 0.3 everywhere, or a float32 copy of ``x0`` (``[B,
    384]``) on ``device``."""
    if x0 is None:
        return torch.full((B, COLS), X0, dtype=torch.float32, device=device)
    if tuple(x0.shape) != (B, COLS) or x0.dtype != torch.float32:
        raise ValueError(f"x0 must be a float32 [{B}, {COLS}] tile, got {x0.dtype} "
                         f"{list(x0.shape)}")
    return x0.to(device, copy=True).contiguous()


def run_variant_reference(name: str, B: int, T: int, seed: int, device="cpu",
                          noise_scale: float = 1e-6, x0: tp.Optional[Tensor] = None) -> Tensor:
    """The plain version: ``make_variant(name)`` applied T times to a
    ``[B, 384]`` tile of 0.3, or ``x0``, on ``device`` (any device: on a
    card it is the yardstick the kernel is held to)."""
    _check_sizes(B, T)
    body = make_variant(name)
    x = _start(B, device, x0)
    for t in range(T):
        x = body(t, x, seed, noise_scale)
    return x


# ------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/op_probe.cu``'s library (one f32 build), built at first use,
    with its C signatures."""
    from ..ops import _build

    lib = _build.load("op_probe")
    lib.op_probe_variant_count.restype = ctypes.c_int
    lib.op_probe_variant_count.argtypes = []
    lib.op_probe_launch.restype = ctypes.c_int
    lib.op_probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]
    lib.op_probe_sincos_2pi.restype = ctypes.c_int
    lib.op_probe_sincos_2pi.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.op_probe_error_string.restype = ctypes.c_char_p
    lib.op_probe_error_string.argtypes = [ctypes.c_int]
    if lib.op_probe_variant_count() != len(VARIANTS):
        raise RuntimeError("op_probe.cu's variants differ from VARIANTS")
    return lib


def _cuda(device, what: str) -> torch.device:
    """``device`` as a CUDA device, or raise: the kernel has no CPU mode."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA device, not {device.type}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (the kernel has no CPU mode; pass "
                           f"device='cpu' for the plain version)")
    return device


def _check_launch(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"op_probe kernel launch failed: "
                           f"{_library().op_probe_error_string(err).decode()} ({err})")


def run_variant(name: str, B: int, T: int, seed: int, device="cuda",
                noise_scale: float = 1e-6, x0: tp.Optional[Tensor] = None) -> Tensor:
    """The ``[B, 384]`` tile after T steps of variant ``name`` from 0.3, or
    from the float32 tile ``x0`` (the JAX probe returned only ``out[0,
    0]``).  On a CUDA device it launches the kernel, or raises where there
    is none; on the CPU it runs the plain version.  ``seed`` keys the draws;
    ``noise_scale`` scales them (the JAX probe's 1e-6)."""
    variant = _check_name(name)
    _check_sizes(B, T)
    if torch.device(device).type == "cpu":
        return run_variant_reference(name, B, T, seed, "cpu", noise_scale, x0)
    device = _cuda(device, "run_variant")
    x = _start(B, device, x0)
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        err = _library().op_probe_launch(variant, x.data_ptr(), out.data_ptr(), x.numel(), T,
                                         seed & 0xFFFFFFFF, noise_scale,
                                         torch.cuda.current_stream().cuda_stream)
    _check_launch(err)
    run_variant.launches += 1
    return out


run_variant.launches = 0


def device_sincos_2pi(u: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """``(cos 2πu, sin 2πu)`` by the chain kernel's own ``sincos_2pi``
    (``csrc/mcpc_common.cuh``), evaluated on the card for a float32 CUDA
    tensor ``u``.  ``device_sincos_2pi.launches`` counts its launches."""
    device = _cuda(u.device, "device_sincos_2pi")
    if u.dtype != torch.float32 or u.numel() == 0:
        raise ValueError("device_sincos_2pi takes a non-empty float32 tensor")
    u = u.contiguous()
    c, s = torch.empty_like(u), torch.empty_like(u)
    with torch.cuda.device(device):
        err = _library().op_probe_sincos_2pi(u.data_ptr(), c.data_ptr(), s.data_ptr(), u.numel(),
                                             torch.cuda.current_stream().cuda_stream)
    _check_launch(err)
    device_sincos_2pi.launches += 1
    return c, s


device_sincos_2pi.launches = 0


def sincos_errors() -> tp.Dict[str, float]:
    """Max abs errors of ``sincos_2pi`` on ``SINCOS_POINTS`` points of [0,
    1) (the JAX probe's check), against cos 2πu and sin 2πu in float64: the
    card's (``device_*``), the plain version's (``plain_*``), and the two
    against each other (``device_vs_plain``)."""
    u = torch.linspace(0.0, 0.999999, SINCOS_POINTS, dtype=torch.float32, device="cuda")
    want_c = torch.cos(2.0 * math.pi * u.double())
    want_s = torch.sin(2.0 * math.pi * u.double())
    dc, ds = device_sincos_2pi(u)
    pc, ps = sincos_2pi(u)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    return {"device_cos": err(dc, want_c), "device_sin": err(ds, want_s),
            "plain_cos": err(pc, want_c), "plain_sin": err(ps, want_s),
            "device_vs_plain": max(err(dc, pc), err(ds, ps))}


# --------------------------------------------------------------- timing


def min_ms(call: tp.Callable[[int], Tensor], reps: int) -> float:
    """The least of ``reps`` timed calls ``call(seed)`` (seeds 2, 3, ...,
    as the JAX probe's ``_min_time``) after one warm-up ``call(1)``, each
    between two CUDA events; an output that is not finite raises."""
    call(1)
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(2 + i)
        end.record()
        end.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("a timed call gave values that are not finite")
        times.append(start.elapsed_time(end))
    return min(times)


def kernel_ms(name: str, B: int, T: int, reps: int) -> float:
    """ms of one ``run_variant`` launch of T steps, least of ``reps``."""
    return min_ms(lambda seed: run_variant(name, B, T, seed), reps)


def marginal_us_per_step(name: str, B: int, t_lo: int = T_LO, t_hi: int = T_HI,
                         reps: int = 5) -> float:
    """µs a step of variant ``name`` at batch B: ``(hi - lo) / (t_hi -
    t_lo)`` over the least kernel times at the two lengths."""
    if not 0 <= t_lo < t_hi:
        raise ValueError(f"need 0 <= t_lo < t_hi, got {t_lo}, {t_hi}")
    lo = kernel_ms(name, B, t_lo, reps)
    hi = kernel_ms(name, B, t_hi, reps)
    return (hi - lo) / (t_hi - t_lo) * 1e3


def _nvidia_smi(query: str, index: int) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                          "-i", str(index)], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def sm_clock_mhz(B: int) -> float:
    """The SM clock (MHz) of the current card that ``nvidia-smi`` reads
    while ``bm_hw`` runs at batch B: launches of 10,000 steps follow each
    other until the reading is back."""
    index = torch.cuda.current_device()
    with ThreadPoolExecutor(max_workers=1) as pool:
        reading = pool.submit(_nvidia_smi, "clocks.sm", index)
        while not reading.done():
            run_variant("bm_hw", B, 10_000, 0)
            torch.cuda.synchronize()
        text = reading.result()
    return float(text.split()[0])


# ----------------------------------------------------------------- bound

# results a clock per SM of the H100 (compute capability 9.0; the CUDA C++
# Programming Guide's table of arithmetic instruction throughput), by pipe.
# "issue" is every operation: one warp instruction a clock on each of the
# SM's 4 sub-partitions.  A shift runs on the ALU or on the integer
# multiply pipe (IMAD.SHL, IMAD.HI), so only the issue rate binds it.  128
# FP32 operations a clock on 132 SMs at 1980 MHz is the 67 TFLOP/s f32
# peak with each an FMA.
PIPE_RATES = {"issue": 128, "fp32": 128, "mufu": 16, "conversion": 16, "imul": 64, "alu": 64}


def _ops(**counts: int) -> collections.Counter:
    return collections.Counter(counts)


# the operations a step needs per element: the fewest instructions that
# compute it with its roundings, by kind ("shift" has no pipe of its own).
# A library function (log, sqrt, rsqrt, sin, cos, exp, tanh, a reciprocal)
# is its one MUFU operation, with the FP32 multiply that scales its argument
# or result for log, sin, cos and exp; |x| and -x are operand modifiers, and
# nothing of the loop itself counts.
_FRAME = _ops(fp32=2)  # x·a + v, rounded twice as the plain version rounds
# counter_bits: one IMAD (the draw's term of the key, onto the hoisted seed
# term and idx); two fmix32, each 3 shifts, 3 xors and 2 multiplies (the
# last xor of the first takes the constant too, a 3-input LOP3);
# unit_from_bits: a shift and an or
_DRAW = _ops(imul=5, alu=7, shift=7)
_LIB = _ops(fp32=1, mufu=1)  # log, sin, cos, exp: the scaling multiply and the MUFU
# u1 = 2 - f1, u2 = f2 - 1; r = sqrt(-2 log u1), the -2 exact in log's scale;
# then x·0.9999 + s·(r·c + r·s): 3 multiplies, an add and the frame
_BOX_MULLER = _DRAW + _DRAW + _ops(fp32=2) + _LIB + _ops(mufu=1) + _ops(fp32=4) + _FRAME
# sincos_2pi (mcpc_common.cuh): 4u, t - q, ·π/2, x², the sine's 5 FMAs and
# multiply, the cosine's 6 FMAs; floor and (int)q; the quadrant's 3
# predicates from qi's bits (one takes a shift and a mask), 2 swapping and
# 2 negating selects
_SINCOS_2PI = _ops(fp32=16, conversion=2, alu=8)
STEP_OPS: tp.Dict[str, collections.Counter] = {
    "baseline": _FRAME,
    "prng": _DRAW + _ops(fp32=1) + _FRAME,
    "log": _ops(fp32=1) + _LIB + _FRAME,
    "sqrt": _ops(fp32=1, mufu=1) + _FRAME,
    "rsqrt": _ops(fp32=1, mufu=1) + _FRAME,
    "sqrt_via_rsqrt": _ops(fp32=2, mufu=1) + _FRAME,
    "sin": _LIB + _FRAME,
    "cos": _LIB + _FRAME,
    "exp": _LIB + _FRAME,
    "sigmoid": _LIB + _ops(fp32=1, mufu=1) + _FRAME,  # exp(-x), 1 + e, its reciprocal
    "tanh": _ops(mufu=1) + _FRAME,
    # 0.5x, tanh, then 0.5 + 0.5·t as one FMA (the halving is exact)
    "sigmoid_tanh": _ops(fp32=2, mufu=1) + _FRAME,
    # θ = 2π·u2, the scaling multiply both MUFU.SIN and MUFU.COS read
    "bm_hw": _BOX_MULLER + _ops(fp32=2, mufu=2),
    "bm_poly": _BOX_MULLER + _SINCOS_2PI,
}


def bound_us_per_step(name: str, elements: int, sms: int,
                      clock_mhz: float) -> tp.Tuple[float, str]:
    """(µs a step, the pipe that sets it) for variant ``name``: the least
    time for ``elements`` elements spread evenly over ``sms`` SMs, each
    pipe's operations (:data:`STEP_OPS`; ``issue`` is their sum) over its
    rate (:data:`PIPE_RATES`), at ``clock_mhz``."""
    ops = STEP_OPS[name]
    counts = dict(ops, issue=sum(ops.values()))
    per_sm = elements / sms
    clocks = {pipe: counts.get(pipe, 0) * per_sm / rate for pipe, rate in PIPE_RATES.items()}
    pipe = max(clocks, key=clocks.get)
    return clocks[pipe] / clock_mhz, pipe


# ----------------------------------------------------------- entry point


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> dict:
    """Print ``sincos_2pi``'s accuracy, then each variant's µs a step, its
    excess over ``baseline`` and its bound, for each batch; return them."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batches", type=int, nargs="*", default=[256], metavar="B")
    p.add_argument("--t-lo", type=int, default=T_LO)
    p.add_argument("--t-hi", type=int, default=T_HI)
    p.add_argument("--reps", type=int, default=5, help="timed calls a length (the least counts)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("vpu_op_bench times the CUDA kernel and needs a CUDA device; "
                           "it has no CPU mode")
    index = torch.cuda.current_device()
    card = _nvidia_smi("name,power.limit", index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    print(card)
    errors = sincos_errors()
    print(f"sincos_2pi max abs err on {SINCOS_POINTS} points: card cos "
          f"{errors['device_cos']:.2e}, sin {errors['device_sin']:.2e}; plain cos "
          f"{errors['plain_cos']:.2e}, sin {errors['plain_sin']:.2e}; card vs plain "
          f"{errors['device_vs_plain']:.2e}")
    results = {"card": card, "sms": sms, "sincos": errors, "batches": {}}
    for B in args.batches:
        clock = sm_clock_mhz(B)
        print(f"== B={B} [{B},{COLS}] f32, marginal us/step (T={args.t_lo} vs {args.t_hi}), "
              f"least of {args.reps}; bound at {clock:.0f} MHz on {sms} SMs ==")
        rows = {}
        for name in VARIANTS:
            us = marginal_us_per_step(name, B, args.t_lo, args.t_hi, args.reps)
            bound, pipe = bound_us_per_step(name, B * COLS, sms, clock)
            rows[name] = {"us": us, "bound_us": bound, "pipe": pipe}
            extra = "" if name == "baseline" else f" (+{us - rows['baseline']['us']:.4f})"
            by_pipe = ", ".join(f"{k} {v}" for k, v in sorted(STEP_OPS[name].items()))
            print(f"  {name:14s}: {us:8.4f} us/step{extra:11s} bound {bound:.4f} ({pipe}), "
                  f"{us / bound:.2f}x; a step needs {by_pipe}")
        results["batches"][B] = {"clock_mhz": clock, "variants": rows}
    return results


if __name__ == "__main__":
    main()
