"""% of its roofline that the bf16 attention backward reaches over the
window: a call's kernels (`flash_attention_bwd_*`: the dq launch, the
dk/dv launch and, where heads are split, the head-sum) against the
five products the gradient needs (`counting/attention.py`). Calls are
counted by their dq launches. Layer: attention kernels."""
from bench.counting import attention as A
from bench.lib.trace import kernel_time


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    t, _ = kernel_time(tr, "flash_attention_bwd_")
    _, calls = kernel_time(tr, "flash_attention_bwd_dq")
    if not calls or t <= 0:
        return None
    s, tf = run["shape"], run["traffic"]
    B = tf["global_batch"] // tf["n_micro"]
    bound = A.backward_bound_s(B, s.n_heads, s.n_kv_heads, tf["seq_len"],
                               s.head_dim)
    return 100.0 * calls * bound / t
