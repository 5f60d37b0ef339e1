"""The flash backward's short-sequence key tiles against its long ones.

When the f32 backward's dK/dV kernel would have fewer than two blocks an
SM, ``csrc/attention_bwd.cu`` takes key tiles of 32 in place of 64
(``few_blocks``).  This script builds the source as it is and a copy
whose ``few_blocks`` always says no (the 64-key tiles everywhere), and
times the f32 backward of each at the training shape (B 8, S = T 128,
H 32/8, hd 128, causal): device ms by CUDA-graph replay, the two
libraries in turns A B B A, both held to the plain backward with
chip_smoke.py's f32 ``BWD_TOL``.

  python3 tools/torch_bwd_tiles.py     (needs a card and nvcc)

Prints the card's name and power limit, then one JSON object.
"""
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.kernels import _build, attention as att  # noqa: E402

SHAPE = (8, 128, 128, 32, 8, 128, 128)      # b, s, t, h, kv, hd, hdv
BWD_TOL = (2e-4, 2e-4)                      # (atol, rtol), f32
REPS = 20
FEW_BLOCKS = re.compile(
    r"(bool few_blocks\(long long n\) \{) return [^}]*\}")


def build_variant(name: str, text: str) -> ctypes.CDLL:
    """``text`` (the backward's source) built beside the library of the
    source itself, with its flags and the shared headers, and loaded."""
    out = _build.BUILD_DIR / "bwd_tiles" / name
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (out / h.name).write_bytes(h.read_bytes())
    (out / "attention_bwd.cu").write_text(text)
    lib = out / "attention_bwd.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "attention_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.flash_attention_backward_launch.argtypes = [p] * 10 + [i] * 10 + [
        f, f, p]
    dll.flash_attention_backward_launch.restype = i
    return dll


def device_ms(fn) -> float:
    """Mean device ms of ``fn()``: REPS calls in one CUDA graph, replayed
    three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3 / REPS


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    src = (_build.CSRC / "attention_bwd.cu").read_text()
    long_only, n = FEW_BLOCKS.subn(r"\1 return false; }", src)
    if n != 1:
        raise SystemExit("few_blocks not found in attention_bwd.cu")
    with ThreadPoolExecutor(3) as ex:
        libs = dict(zip(("as built", "long tiles"), ex.map(
            build_variant, ("as_built", "long_tiles"), (src, long_only))))
        ex.submit(_build.build, "attention").result()
    dev = torch.device("cuda", 0)
    b, s, t, h, kv, hd, hdv = SHAPE
    rng = np.random.default_rng(0)
    result = {"card": card, "shape": list(SHAPE), "causal": True,
              "dtype": "float32", "reps": REPS, "tilings": {}}
    q, k, v = (torch.from_numpy(rng.standard_normal(shp, np.float32)).to(dev)
               for shp in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hdv)))
    o, lse = att.flash_attention_with_lse(q, k, v, causal=True)
    do = torch.from_numpy(rng.standard_normal(tuple(o.shape),
                                              np.float32)).to(dev)
    want = att.flash_attention_backward_plain(q, k, v, o, do)
    for turn in ("as built", "long tiles", "long tiles", "as built"):
        att._bwd_lib = lambda lib=libs[turn]: lib

        def run():
            return att.flash_attention_backward(q, k, v, o, do, lse,
                                                causal=True)
        got = run()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.allclose(g, w, atol=BWD_TOL[0], rtol=BWD_TOL[1])
                   for g, w in zip(got, want)):
            raise SystemExit(f"{turn}: outside {BWD_TOL} of plain (max abs "
                             f"err {err:.3g})")
        entry = result["tilings"].setdefault(turn, {"ms": [],
                                                    "max_abs_err": 0.0})
        entry["ms"].append(device_ms(run))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
