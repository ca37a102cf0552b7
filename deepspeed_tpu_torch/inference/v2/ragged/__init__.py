from .blocked_allocator import NULL_PAGE, BlockedAllocator, KVAllocationError
from .batch import RaggedBatch, build_batch
from .kv_cache import BlockedKVCache, KVCacheConfig
from .manager import StateManager
from .sequence import SequenceDescriptor, placeholder

__all__ = [
    "NULL_PAGE", "BlockedAllocator", "KVAllocationError", "RaggedBatch",
    "build_batch", "BlockedKVCache", "KVCacheConfig",
    "StateManager", "SequenceDescriptor", "placeholder",
]
