#!/usr/bin/env python3
"""Run the TF32 walk of the paged decode attention kernel (K5's route 3)
on every ``chip_smoke.WIDE_K5`` row it takes, fp32 and bf16, each against
its plain version, so that a memory checker can watch its reads:

    compute-sanitizer --tool memcheck python3 tools/decode_walk_memcheck.py

The rows cover ragged widths (rows that are not whole 16-byte chunks), a
table that names the pool's last slot at a full page, several tiles a
split, Q resident beside the ring, and tokens whose shifts differ from
tile to tile while the copies run tiles ahead.  Prints one JSON line a row and
exits 1 if a row disagrees with its plain version, or without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "src")]

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_walk_memcheck: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import decode_attention as da
    bad = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d, dv, page, P, *opts in cs.WIDE_K5:
            if da.instance(d, dv, dtype)[0] != "walk":
                continue
            args = cs.wide_k5_case(d, dv, page, P, dtype, *opts)
            out = da.paged_decode_attention_kernel(*args)
            plain = da.paged_decode_plain(*args)
            torch.cuda.synchronize()
            ok = cs.decode_agrees(out, plain, cs.TOL[dtype])
            bad += not ok
            print(json.dumps(dict(d=d, dv=dv, page=page, P=P,
                                  dtype=str(dtype).split(".")[-1],
                                  max_abs_err=cs.max_err(out, plain),
                                  agrees=ok)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
