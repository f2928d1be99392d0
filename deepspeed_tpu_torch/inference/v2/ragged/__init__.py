from .blocked_allocator import BlockedAllocator
from .cache_telemetry import CacheTelemetry, MRCEstimator, chunk_key
from .kv_cache import BlockedKVCache
from .prefix_cache import PrefixKVCache, PrefixMatch
from .ragged_manager import DSStateManager
from .ragged_wrapper import RaggedBatch, RaggedBatchWrapper
from .sequence_descriptor import DSSequenceDescriptor
