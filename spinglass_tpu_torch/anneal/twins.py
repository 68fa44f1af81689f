"""Twin engines: the engines ``make_engine`` picks on the card, with each
kernel swapped for its plain PyTorch version on the kernel's own Philox
stream.

They exist to check ``sa``, ``pt`` and the RL env end to end: a run through
an engine and a run through its twin under one generator seed draw the same
seeds, so on exact couplings (+-J, fields on a quarter grid) every piece of
the state must be equal bit for bit. A seed may be a captured step's seed
slot: the plain versions then compute on it where it lies. ``make_engine`` never picks them, and they launch no
kernel: their ``launches`` stay at 0.
"""

from __future__ import annotations

from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
from spinglass_tpu_torch.kernels import metropolis_cuda as mc
from spinglass_tpu_torch.kernels import sparse_cuda as sc
from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine
from spinglass_tpu_torch.core.rng import draw_seed


class TwinFusedEngine(CudaFusedEngine):
    """``CudaFusedEngine`` sweeping through K1's plain version on the
    uniforms K1 would draw under the same seed."""

    def sweep(self, spins_t, beta, generator):
        f = self.fused
        u = mc.philox_uniforms(draw_seed(generator), *spins_t.shape,
                               device=spins_t.device)
        return mc.fused_sweep_reference(
            self.problem.j, self.problem.h, self.problem.active_mask,
            spins_t, beta, u, f.rule, f.block_size)


class TwinSparseTEngine(SortedSparseTEngine):
    """``SortedSparseTEngine`` sweeping through the per-colour plain sweep
    on the kernels' Philox thresholds: K2's plain version, and on exact
    couplings K4's too, for float32 and int8 spins."""

    def sweep(self, spins_t, beta, generator):
        th = sc.thresholds_reference(self.mask_col, beta, draw_seed(generator),
                                     spins_t.shape[1], self.rule)
        return sc.single_sweep_reference(self.groups, spins_t, th)
