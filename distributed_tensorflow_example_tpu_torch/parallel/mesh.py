"""The data axis over the process group (the part of the JAX package's
``parallel/mesh.py`` with no tensor, sequence, expert, pipeline or site
axis).

JAX builds a ``Mesh`` over the devices of one process: under
``--data_parallel N`` device r holds rows ``[r*B/N, (r+1)*B/N)`` of
every global batch, shard r of the device-resident split, and a replica
(or a 1/N shard) of the train state; gradients are summed over the
axis by ``psum``.  The port runs one process per device, and **rank r
plays device r**: the same rows, the same shard, the same state, the
sums by ``torch.distributed`` collectives over the group.

So the data axis is the whole group.  ``--data_parallel -1`` takes the
world size, and any other value must equal it: JAX leaves devices past
``dp`` idle, but a rank cannot sit out the collectives of the others.
The multi-axis builders (``build_seq_mesh``, ``build_expert_mesh``,
``build_stage_mesh``, ``build_site_mesh``, ``build_nd_mesh``) and
``param_pspecs`` wait for tensor, sequence, expert and pipeline
parallelism (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses

from .. import cluster
from ..config import Unported

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
SITE_AXIS = "site"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``dp`` ranks, this process at ``rank``."""
    dp: int
    rank: int


def build_mesh(data_parallel: int = -1, model_parallel: int = 1,
               world: int | None = None, rank: int | None = None) -> Mesh:
    """The ('data',) layout over ``world`` ranks (default: the process
    group's, 1 without one).  ``data_parallel`` -1 is the world size; a
    value above it raises JAX's message, one below it the port's own
    (every rank must take part in the data axis)."""
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    if model_parallel != 1:
        raise Unported(f"model_parallel={model_parallel}: tensor "
                       f"parallelism is not ported to the PyTorch trainer "
                       f"yet (see ROADMAP.md Queue A)")
    dp = n if data_parallel == -1 else data_parallel
    if dp < 1:
        raise ValueError(f"data_parallel={dp} must be >= 1 (or -1)")
    if dp * model_parallel > n:
        raise ValueError(
            f"mesh {dp}x{model_parallel} needs {dp * model_parallel} "
            f"devices, have {n}")
    if dp < n:
        raise ValueError(
            f"data_parallel={dp} leaves {n - dp} of {n} ranks off the data "
            f"axis: in the PyTorch port every rank plays one device of the "
            f"mesh, so --data_parallel must be -1 or the world size {n}")
    return Mesh(dp=dp, rank=r)


def layer_styles(spec, model_parallel: int = 1) -> list:
    """Per-layer tensor-parallel style: every layer replicated ("rep")
    at ``model_parallel`` 1 (the transformer's one entry, as JAX's)."""
    from ..models.transformer import TransformerSpec

    if model_parallel != 1:
        raise Unported(f"model_parallel={model_parallel}: tensor "
                       f"parallelism is not ported to the PyTorch trainer "
                       f"yet (see ROADMAP.md Queue A)")
    if isinstance(spec, TransformerSpec):
        return ["rep"]
    return ["rep"] * spec.num_layers


def batch_layout(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch this rank takes: the batch splits over
    the data axis into dp equal blocks, and rank r takes block r, as
    JAX's ``P('data')`` gives device r its block."""
    if global_batch % mesh.dp:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"data_parallel={mesh.dp}")
    b = global_batch // mesh.dp
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS",
           "STAGE_AXIS", "SITE_AXIS", "Mesh", "build_mesh", "layer_styles",
           "batch_layout"]
