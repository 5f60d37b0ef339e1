"""Shared set-up of the benchmark's tests: the harness's and the
program's sources on the path, and cells of the benchmark cut to a size
the CPU runs in a second (same files, same code, tiny widths)."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from pbcore import cell  # noqa: E402

TINY = {
    "qwen2-vl-7b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, num_layers=2,
                        mrope_sections=[4, 2, 2]),
    "deepseek-moe-16b": dict(d_model=64, num_heads=4, num_kv_heads=4,
                             head_dim=16, d_ff=128, vocab_size=512,
                             num_layers=3, num_experts=8, top_k=2,
                             num_shared_experts=1, moe_d_ff=32),
}
TINY_SERVE = dict(prompt_tokens=32, new_tokens=4, max_batch=4,
                  check_tokens=8, warmup_batches=[4])
TINY_MIX = {
    "chat_prefix": dict(TINY_SERVE, shared_prefix={"tokens": 16, "count": 4,
                                                   "zipf_s": 1.1},
                        arrival={"rate_per_s": 20.0, "backlog": 0,
                                 "drain": True}),
    "unique_docs": dict(TINY_SERVE, arrival={"rate_per_s": 40.0,
                                             "backlog": 4, "drain": False}),
    "train_4k": dict(batch=2, seq=32),
}
CELLS = ["qwen2vl7b.chat_prefix", "dsmoe16b.unique_docs",
         "qwen2vl7b.train_4k"]


def tiny_cell(name: str, root: Path = BENCH.parent) -> cell.Cell:
    c = cell.load(name, root)
    base = c.config["repo_config"]
    mix = dict(json.loads(json.dumps(c.mix)), **TINY_MIX[c.traffic])
    return c._replace(config=dict(c.config, **TINY[base]), mix=mix)


def tiny_ctx(name: str, seed: int = 2 ** 31 + 11, trace: bool = False,
             seconds: float = 1.0) -> cell.Ctx:
    torch.manual_seed(0)
    return cell.Ctx(tiny_cell(name), seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode and the control's TF32 exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)
