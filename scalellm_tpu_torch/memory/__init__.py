from scalellm_tpu_torch.memory.block import Block
from scalellm_tpu_torch.memory.block_allocator import BlockAllocator
from scalellm_tpu_torch.memory.block_manager import BlockManager, BlockManagerOptions
from scalellm_tpu_torch.memory.prefix_cache import PrefixCache

__all__ = [
    "Block",
    "BlockAllocator",
    "BlockManager",
    "BlockManagerOptions",
    "PrefixCache",
]
