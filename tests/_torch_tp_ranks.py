"""The ranks' side of ``test_torch_tp.py``: spawned by
``repro_torch.launch.mesh.spawn``, so it imports nothing of JAX."""
import torch

from repro_torch.launch.serve import serve_rank
from repro_torch.runtime.compression import int8_psum


def rank_main(group, jobs: list, psum_cases):
    """Serve ``jobs`` over ``group`` (rank 0 returns their tokens and
    stats), then ``int8_psum`` each case's slice of this rank."""
    served = serve_rank(group, jobs)
    summed = [int8_psum(torch.from_numpy(case[group.rank]), group.pg).numpy()
              for case in psum_cases]
    return {"served": served, "int8_psum": summed}
