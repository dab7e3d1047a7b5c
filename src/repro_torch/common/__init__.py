from .device import Device, resolve_device  # noqa: F401
from .pytree import (  # noqa: F401
    Tree, flatten, flatten_with_paths, param_bytes, param_count, path_key,
    sorted_tree, tree_add, tree_map, tree_map_with_path, tree_paths,
    tree_stack, tree_sub, unflatten,
)
