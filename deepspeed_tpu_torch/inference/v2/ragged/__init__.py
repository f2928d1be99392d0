from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache
from .ragged_manager import DSStateManager
from .ragged_wrapper import RaggedBatch, RaggedBatchWrapper
from .sequence_descriptor import DSSequenceDescriptor
