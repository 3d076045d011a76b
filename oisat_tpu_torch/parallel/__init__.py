"""Multi-device scaling of the port: the device mesh (:mod:`.mesh`) and the
sharded month steps (:mod:`.analysis`, ``make_*_step``).

Counterpart of :mod:`oisat_tpu.parallel`: the granule batch is split over
the mesh's 'obs' axis and the analysis grid's rows over its 'grid' axis; the
monthly reduction over granules and the mean-AK curve's sums are added
across shards in a fixed order on one device.
"""

from oisat_tpu_torch.parallel.mesh import Mesh, factor2, make_mesh

__all__ = ["Mesh", "make_mesh", "factor2"]
