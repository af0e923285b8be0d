from .mesh import (build_multi_plot_trainer, make_mesh, replicate,  # noqa: F401
                   shard_plot, shard_states, shard_views, stack_states)
