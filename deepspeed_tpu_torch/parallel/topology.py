"""N-dimensional process topology.

Counterpart of ``deepspeed_tpu/parallel/topology.py`` (the reference's
``deepspeed/runtime/pipe/topology.py``: ``ProcessTopology:12``,
``PipeDataParallelTopology:232``, ``PipeModelDataParallelTopology:244``,
``PipelineParallelGrid:251``): a cartesian grid mapping named axes to
ranks, the first axis outermost. Here a rank is a ``torch.distributed``
rank; the port's mesh (``parallel/mesh.py``) lays its ranks out in the same
order, ``pipe`` outermost, so ``PipeDataParallelTopology(P, D)``'s rank of
(pipe p, data d) is the mesh's.
"""

from itertools import product
from collections import namedtuple


class ProcessTopology:
    """Cartesian axis grid. API mirrors the reference class of the same name."""

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        ranges = [range(d) for d in dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError("get_rank() does not support slices, use filter_match())")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"coord {coord_kwargs} not in topology"
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", ), inner_sep="_", outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology")

    def get_axis_comm_lists(self, axis):
        """Lists of ranks that vary only along ``axis`` (reference :127)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for coord in product(*ranges):
            other = dict(zip(other_axes, coord))
            ranks = [self.get_rank(**{axis: i}, **other) for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        def _match(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return [rank for coord, rank in self.mapping.items() if _match(coord)]

    def get_axis_list(self, axis, idx):
        return [rank for coord, rank in self.mapping.items() if getattr(coord, axis) == idx]

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """Pipe-major × data topology (reference :232)."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3D pipe × data × model topology (reference :244)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Axis bookkeeping for the pipeline engine (reference :251).

    Holds the stage id / dp id of the current rank plus neighbors, from the
    topology's coordinates of ``global_rank``.
    """

    def __init__(self, topology, global_rank=0):
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size()
        self.pipe_parallel_size = topology.get_dim("pipe")
        self.data_parallel_size = topology.get_dim("data")
        self.model_parallel_size = max(1, topology.get_dim("model"))
        coord = topology.get_coord(global_rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)

    def get_stage_id(self):
        return self.stage_id

    def get_data_parallel_id(self):
        return self.data_parallel_id

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_global_rank(self):
        return self.global_rank

    def stage_to_global(self, stage_id, **kwargs):
        coord = self._topo.get_coord(self.global_rank)
        me = coord._asdict()
        me.update(kwargs)
        me["pipe"] = stage_id
        return self._topo.get_rank(**me)

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1
