"""Block-sparsity layout generators for sparse self-attention.

A copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (numpy
only), so the PyTorch port builds the same layouts bit for bit. Analog of
the reference ``deepspeed/ops/sparse_attention/sparsity_config.py``: the
same six pattern classes with the same constructor surface —
``SparsityConfig`` base (:10), Dense (:63), Fixed (:95, Sparse-Transformer
style local+global), Variable (:239, random + per-window local + indexed
global), BigBird (:411, random + sliding + ITC-global), BSLongformer (:546,
sliding + indexed global), LocalSlidingWindow (:674).

- layouts are **numpy** ``int8`` arrays, built on the host. The block-sparse
  kernel reads the layout as a per-(head, row) column LUT
  (``ops/block_sparse_attention.py::make_layout_lut``), copied to the device
  once per sequence length.
- random patterns take an explicit ``seed`` (default 0) so every rank
  derives the identical layout — the reference instead samples
  nondeterministically and broadcasts from rank 0
  (``sparse_self_attention.py:53``); with a seeded generator the broadcast
  is unnecessary.
"""

import numpy as np


class SparsityConfig:
    """Base class holding the shared properties of blocked sparsity patterns
    (reference ``sparsity_config.py:10``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        """Zero layout of shape (num_heads, num_blocks, num_blocks)."""
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence Length, {seq_len}, needs to be dividable by Block size {self.block}!")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int8)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active — kept for comparison/comprehension (reference :63)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (arxiv 1904.10509; reference :95):
    local windows of ``num_local_blocks`` plus ``num_global_blocks`` global
    representative blocks per window."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_local_blocks=4,
                 num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of blocks in a local window, {num_local_blocks}, "
                f"must be dividable by number of global blocks, {num_global_blocks}!")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError('only "uni/bi-directional" attentions are supported for now!')
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError('only "bi-directional" attentions can support horizontal global attention!')
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "Number of different layouts cannot be more than one when you have set a single layout"
                " for all heads! Set different_layout_per_head to True.")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"Number of layout versions (num_different_global_patterns), "
                f"{num_different_global_patterns}, cannot be larger than number of local window "
                f"blocks divided by number of global blocks, "
                f"{num_local_blocks} / {num_global_blocks} = {num_local_blocks // num_global_blocks}!")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        r = np.arange(nb)
        same_window = (r[:, None] // self.num_local_blocks) == (r[None, :] // self.num_local_blocks)
        if self.attention == "unidirectional":
            same_window &= r[None, :] <= r[:, None]
        layout[h][same_window] = 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        first = L - (1 + h % self.num_different_global_patterns) * G
        end = nb - nb % L
        starts = list(range(first, end, L))
        if end < nb:  # short last window: clamp so the global band stays in range
            starts.append(min(end + first, nb - G))
        for i in starts:
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + G] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + G, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Extension of Fixed (reference :239): optional random blocks, a list of
    local window sizes, and explicit global block indices/ranges."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks=None,
                 global_block_indices=None,
                 global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        local_window_blocks = [4] if local_window_blocks is None else local_window_blocks
        global_block_indices = [0] if global_block_indices is None else global_block_indices
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, {len(global_block_indices)}, must be same"
                    f" as global block end indices length, {len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(global_block_indices, global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be smaller than global block"
                        f" end index, {end_idx}!")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError('only "uni/bi-directional" attentions are supported for now!')
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError('only "bi-directional" attentions can support horizontal global attention!')
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def set_random_layout(self, h, layout, rng):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be smaller than overall"
                f" number of blocks in a row, {nb}!")
        for row in range(nb):
            # unidirectional layouts must stay block-lower-triangular: sample
            # random blocks only from the row's past (incl. diagonal)
            pool = nb if self.attention == "bidirectional" else row + 1
            n = min(self.num_random_blocks, pool)
            layout[h, row, rng.choice(pool, n, replace=False)] = 1
        return layout

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        windows = list(self.local_window_blocks)
        # the last listed window size tiles the remainder of the sequence
        covered = sum(windows)
        while covered < nb:
            windows.append(windows[-1])
            covered += windows[-1]
        start = 0
        for w in windows:
            end = min(start + w, nb)
            for row in range(start, end):
                hi = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:hi] = 1
            start += w
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices, self.global_block_end_indices))
        for start_idx, end_idx in ranges:
            if start_idx >= nb:
                continue
            end_idx = min(end_idx, nb)
            if self.horizontal_global_attention:
                layout[h, start_idx:end_idx, :] = 1
            first_row = 0 if self.attention == "bidirectional" else start_idx
            layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout, rng)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird pattern (arxiv 2007.14062; reference :411): random + sliding
    window + ITC global (first blocks attend/attended everywhere)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=1,
                 num_sliding_window_blocks=3,
                 num_global_blocks=1,
                 attention="bidirectional",
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError('only "uni/bi-directional" attentions are supported for now!')
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def set_random_layout(self, h, layout, rng):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be smaller than overall"
                f" number of blocks in a row, {nb}!")
        for row in range(nb):
            pool = nb if self.attention == "bidirectional" else row + 1
            n = min(self.num_random_blocks, pool)
            layout[h, row, rng.choice(pool, n, replace=False)] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks, {self.num_sliding_window_blocks}, must be"
                f" smaller than overall number of blocks in a row, {nb}!")
        r = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        layout[h][np.abs(r[:, None] - r[None, :]) <= w] = 1
        return layout

    def set_global_layout_itc(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError(
                f"Number of global blocks, {self.num_global_blocks}, must be smaller than overall"
                f" number of blocks in a row, {nb}!")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout, rng)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (arxiv 2004.05150; reference :546): sliding
    window + explicit global block indices/ranges."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices=None,
                 global_block_end_indices=None,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        global_block_indices = [0] if global_block_indices is None else global_block_indices
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, {len(global_block_indices)}, must be same"
                    f" as global block end indices length, {len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(global_block_indices, global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be smaller than global block"
                        f" end index, {end_idx}!")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError('only "uni/bi-directional" attentions are supported for now!')
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks, {self.num_sliding_window_blocks}, must be"
                f" smaller than overall number of blocks in a row, {nb}!")
        r = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        layout[h][np.abs(r[:, None] - r[None, :]) <= w] = 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices, self.global_block_end_indices))
        for start_idx, end_idx in ranges:
            if start_idx >= nb:
                continue
            end_idx = min(end_idx, nb)
            layout[h, start_idx:end_idx, :] = 1
            layout[h, :, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely-local sliding window pattern (reference :674)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3, attention="unidirectional"):
        super().__init__(num_heads, block)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError('only "uni/bi-directional" attentions are supported for now!')
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks, {self.num_sliding_window_blocks}, must be"
                f" smaller than overall number of blocks in a row, {nb}!")
        r = np.arange(nb)
        w = self.num_sliding_window_blocks // 2
        mask = (r[:, None] - r[None, :] <= w) & (r[None, :] - r[:, None] <= (w if self.attention == "bidirectional" else 0))
        layout[h][mask] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


_MODE_CLASSES = {
    "dense": (DenseSparsityConfig,
              ("block", "different_layout_per_head")),
    "fixed": (FixedSparsityConfig,
              ("block", "different_layout_per_head", "num_local_blocks",
               "num_global_blocks", "attention", "horizontal_global_attention",
               "num_different_global_patterns")),
    "variable": (VariableSparsityConfig,
                 ("block", "different_layout_per_head", "num_random_blocks",
                  "local_window_blocks", "global_block_indices",
                  "global_block_end_indices", "attention",
                  "horizontal_global_attention", "seed")),
    "bigbird": (BigBirdSparsityConfig,
                ("block", "different_layout_per_head", "num_random_blocks",
                 "num_sliding_window_blocks", "num_global_blocks", "attention", "seed")),
    "bslongformer": (BSLongformerSparsityConfig,
                     ("block", "different_layout_per_head",
                      "num_sliding_window_blocks", "global_block_indices",
                      "global_block_end_indices", "attention")),
    "local": (LocalSlidingWindowSparsityConfig,
              ("block", "num_sliding_window_blocks", "attention")),
}


def build_sparsity_config(sparsity: dict, num_heads: int):
    """Build a SparsityConfig from a ``sparse_attention`` JSON config block
    (reference ``runtime/config.py:289`` ``get_sparse_attention`` — mode +
    per-mode keys, same names). Unknown modes raise, matching the reference's
    NotImplementedError; unknown/wrong-mode KEYS also raise — a typo'd key
    silently falling back to a class default would train a different
    sparsity pattern than configured."""
    mode = sparsity.get("mode", "fixed")
    if mode not in _MODE_CLASSES:
        raise NotImplementedError(f"Given sparsity mode, {mode}, has not been implemented yet!")
    cls, keys = _MODE_CLASSES[mode]
    allowed = set(keys) | {"mode"}
    unknown = set(sparsity) - allowed
    if unknown:
        raise ValueError(f"sparse_attention mode {mode!r} got unknown keys {sorted(unknown)}; "
                         f"allowed: {sorted(allowed)}")
    return cls(num_heads=num_heads, **{k: sparsity[k] for k in keys if k in sparsity})
