"""% of its roofline that the forward flash-attention kernel
(`flash_attention_sm90_kernel`) reaches over the window: the launches'
bounds (`counting/attention.py`) over their device time. Layer:
attention kernels."""
from bench.counting import attention as A
from bench.lib.trace import kernel_time


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    t, n = kernel_time(tr, "flash_attention_sm90_kernel")
    if not n or t <= 0:
        return None
    s, tf = run["shape"], run["traffic"]
    B = tf["global_batch"] // tf["n_micro"]
    bound = A.forward_bound_s(B, s.n_heads, s.n_kv_heads, tf["seq_len"],
                              s.head_dim)
    return 100.0 * n * bound / t
