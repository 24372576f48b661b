"""ET facade + predictor (`models/agentformer.py`): the share of the
window's attentions that took the fused op, 100 x `agentformer.attn_fused`
/ (`agentformer.attn_fused` + `agentformer.attn_plain`), from the program's
trace counters, in %; nothing where the program counts neither."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from eigentrajectory_tpu_torch.utils.profiling import counters
    except ImportError:            # a program with no trace counters
        return None
    c = counters()
    fused, plain = c.get("agentformer.attn_fused", 0), c.get("agentformer.attn_plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
