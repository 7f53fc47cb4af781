"""block_stream's design sweep on the card: the shipped kernel
(csrc/block_stream.cu) and variants of its grid and its memory operations
(probes/block_stream_sweep.cu), timed at P4 S's shape (out[blk] = t[blk] + 1
over revolve_probe's 1 GiB table, separate output), at P4 D's (the same
walk read from ib) and at P2a's in place (stream_variants' 2.66 GB table, t
* 1.000001 + 0.5), beside P4's `t + 1` (E) and `copy_` (C) and P2a's
`copy_`. The variants:

  chunk <KB> <threads> <hint>   one CTA a chunk of the walk (the shipped
                                kernel's form)
  card x<waves> <threads> <hint>  SMs x resident CTAs x waves CTAs, each an
                                equal contiguous share of the walk
  ... depth <n>                 n 16-byte loads in flight a thread
  tma <KB> <stages>             cp.async.bulk in and out through shared
                                memory, one persistent CTA per resident slot

hints: plain loads and stores, cs (__ldcs/__stcs), ef (an L2 evict_first
policy). Every variant is checked once against block_stream_plain, bit for
bit, on a permuted walk and on the static map in place; times are CUDA
events around 20 calls after one, two passes over the list.

    python -m dlrm_tpu_torch.probes.block_stream_sweep
"""

from __future__ import annotations

import ctypes
import sys

import torch

from dlrm_tpu_torch.buildlib import build_shared
from dlrm_tpu_torch.ops.probe_kernels import block_stream, block_stream_plain
from dlrm_tpu_torch.ops.stream_kernels import _NVCC_FLAGS, _nvcc
from dlrm_tpu_torch.probes import revolve_probe as p4
from dlrm_tpu_torch.probes import stream_variants as p2
from dlrm_tpu_torch.probes.common import probe_device, time_ms

HINTS = {"plain": 0, "cs": 1, "ef": 2}
ITERS = 20
_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)


def configs():
    """name -> (kind, threads, depth, hint, stages, chunk KB or None,
    waves or None)."""
    out = {"shipped": None}
    for kb in (8, 16, 32, 64):
        for th in (256, 512):
            for hint in HINTS:
                out[f"chunk {kb} {th} {hint}"] = (0, th, 1, hint, 0, kb, None)
    # one or two rounds of depth loads a thread
    for th, depth in ((128, 4), (256, 1), (256, 2), (256, 4), (512, 2),
                      (512, 4), (1024, 1)):
        for reps in (1, 2):
            kb = th * depth * reps // 64
            name = f"chunk {kb} {th} plain" + (f" depth {depth}"
                                               if depth > 1 else "")
            out.setdefault(name, (0, th, depth, "plain", 0, kb, None))
    for waves in (1, 2, 4):
        for th in (256, 512):
            for hint in HINTS:
                out[f"card x{waves} {th} {hint}"] = (0, th, 1, hint, 0, None,
                                                     waves)
    for depth in (2, 4):
        out[f"card x1 256 plain depth {depth}"] = (0, 256, depth, "plain", 0,
                                                   None, 1)
    for kb in (8, 16, 32):
        for stages in (2, 3):
            out[f"tma {kb} {stages}"] = (1, 256, 1, "plain", stages, kb, None)
    return out


def main(device: str = "cuda") -> dict:
    """Build the sweep, check every variant, time it; prints one line a
    variant and returns {name: {"P4 S", "P4 D", "P2a": [ms of each pass]}}."""
    dev = probe_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the block_stream sweep times the card: it needs "
                           "CUDA")
    lib = ctypes.CDLL(build_shared(
        "block_stream_sweep", ["probes/block_stream_sweep.cu"],
        [_nvcc(), *_NVCC_FLAGS], deps=["csrc/block_stream.cu"]))
    lib.bs_sweep.argtypes = [_I, _I, _I, _I, _I, _I64, _I64, _P, _P, _P,
                             _I64, _I64, _I64, _F, _F, _P]
    lib.bs_sweep_resident.argtypes = [_I, _I, _I, _I, _I, _I64, _I]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def runner(cfg, t, ib, out, br, scale, shift):
        """fn() launching cfg on t (out None: in place)."""
        kw = dict(scale=scale, shift=shift, block_rows=br)
        if cfg is None:
            return lambda: block_stream(t, ib, out=out, **kw)
        kind, th, depth, hint, stages, kb, waves = cfg
        total4 = t.numel() // 4
        block4 = br * t.shape[1] // 4
        n_walk = ib.numel() if ib is not None else -(-t.shape[0] // br)
        walk4 = n_walk * block4 if ib is not None else total4
        res = lib.bs_sweep_resident(kind, th, depth, HINTS[hint], stages,
                                    (kb or 16) * 64, int(ib is not None))
        if res <= 0:
            raise RuntimeError(f"{cfg}: occupancy query failed ({res})")
        if kind == 1:
            share4, grid = kb * 64, sms * res
        elif kb is not None:
            share4 = kb * 64
            grid = -(-walk4 // share4)
        else:
            share4 = -(-walk4 // (sms * res * waves))
            share4 = -(-share4 // 256) * 256
            grid = -(-walk4 // share4)
        dst = t if out is None else out
        args = (kind, th, depth, HINTS[hint], stages, share4, grid,
                t.data_ptr(), dst.data_ptr(),
                None if ib is None else ib.data_ptr(), n_walk, block4,
                total4, scale, shift)

        def fn():
            err = lib.bs_sweep(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"bs_sweep {cfg}: CUDA error {err}")
        return fn

    # the checks: a permuted walk out of place, the static map in place
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    small = torch.randn((64 * p4.BR, p4.D_), generator=gen, device=dev)
    perm = torch.randperm(64, generator=gen, device=dev).int()[:40]
    out0 = torch.full_like(small, -7.0)
    want_d = block_stream_plain(small, perm, out=out0.clone(), scale=1.5,
                                shift=0.25, block_rows=p4.BR)
    want_n = block_stream_plain(small.clone(), scale=1.5, shift=0.25,
                                block_rows=p4.BR)
    cfgs = configs()
    for name, cfg in cfgs.items():
        got = out0.clone()
        runner(cfg, small, perm, got, p4.BR, 1.5, 0.25)()
        inplace = small.clone()
        runner(cfg, inplace, None, None, p4.BR, 1.5, 0.25)()
        torch.cuda.synchronize()
        if not (torch.equal(got, want_d) and torch.equal(inplace, want_n)):
            raise AssertionError(f"sweep {name}: differs from the plain "
                                 "version")
    print(f"block_stream sweep: {len(cfgs)} variants bit-identical to the "
          f"plain version ({sms} SMs)", flush=True)
    del small, out0, want_d, want_n

    t4 = torch.ones((p4.NBLK * p4.BR, p4.D_), device=dev)
    o4 = torch.empty_like(t4)
    ident = torch.arange(p4.NBLK, dtype=torch.int32, device=dev)
    t2 = torch.randn((p2.R, p2.D), generator=gen, device=dev)
    c2 = torch.empty_like(t2)
    gb4, gb2 = 2 * t4.numel() * 4 / 1e9, 2 * t2.numel() * 4 / 1e9
    yard = {"P4 E (t + 1)": (lambda: t4 + 1.0, gb4),
            "P4 C (copy_)": (lambda: o4.copy_(t4), gb4),
            "P2a copy_": (lambda: c2.copy_(t2), gb2)}
    res = {}
    for rnd in range(2):
        for name, (fn, gb) in yard.items():
            ms = time_ms(fn, dev, ITERS)
            res.setdefault(name, []).append(ms)
            print(f"pass {rnd} {name:34s} {ms:8.4f} ms {gb / ms * 1e3:8.1f} "
                  "GB/s", flush=True)
        for name, cfg in cfgs.items():
            times = {
                "P4 S": time_ms(runner(cfg, t4, None, o4, p4.BR, 1.0, 1.0),
                                dev, ITERS),
                "P4 D": time_ms(runner(cfg, t4, ident, o4, p4.BR, 1.0, 1.0),
                                dev, ITERS),
                "P2a": time_ms(runner(cfg, t2, None, None, p2.BR, p2.SCALE,
                                      p2.SHIFT), dev, ITERS),
            }
            for k, v in times.items():
                res.setdefault(name, {}).setdefault(k, []).append(v)
            print(f"pass {rnd} {name:34s} P4 S {times['P4 S']:8.4f}  P4 D "
                  f"{times['P4 D']:8.4f}  P2a in place {times['P2a']:8.4f} ms",
                  flush=True)
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
