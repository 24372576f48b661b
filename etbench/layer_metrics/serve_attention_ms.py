"""ET facade + predictor (`models/agentformer.py`, `ops/csrc/agent_attention.cu`):
device ms a request of the operations named `agent_attention_kernel`, the
hand-written agent-aware attention; nothing where no such operation ran."""
from etbench.layers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, lambda t: t.op_seconds(lambda name: "agent_attention_kernel" in name))
