"""The static-graph (Program) path of the port: Program IR, layers' ops,
append_backward, the pass pipeline, the control-flow blocks
(``nested.py``), the debugger and the Executor (see the modules)."""

from paddle_tpu_torch.static.program import (  # noqa: F401
    OP_REGISTRY, Block, Operator, Parameter, Program, Variable, data,
    default_main_program, default_startup_program, disable_static,
    enable_static, in_static_mode, name_scope, program_guard, register_op,
    static_mode_guard,
)
# registers the fused_matmul compute: an optimized program must run
# without the pass pipeline having run in this process
import paddle_tpu_torch.static.opt_passes  # noqa: F401,E402
from paddle_tpu_torch.static.backward import (  # noqa: E402,F401
    append_backward, gradients,
)
from paddle_tpu_torch.static.io import (  # noqa: E402,F401
    append_load_op, append_save_op, load_inference_model, load_params,
    load_persistables, save_inference_model, save_params, save_persistables,
)
from paddle_tpu_torch.static.debugger import (  # noqa: E402,F401
    draw_graph, memory_usage, pprint_program,
)
import paddle_tpu_torch.static.nested  # noqa: F401,E402
from paddle_tpu_torch.static.executor import (  # noqa: E402
    AsyncExecutor, Executor, Scope, device_prefetch, global_scope,
    scope_guard,
)
from paddle_tpu_torch.compiler import (  # noqa: E402,F401
    BuildStrategy, CompiledProgram, ExecutionStrategy,
)
