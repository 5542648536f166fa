"""Hand-written CUDA kernels for Hopper and their wrappers."""


def launch_counters() -> dict:
    """Each kernel's launch counter, by kernel name: its wrapper counts
    where it launches the kernel (the CPU's plain versions do not
    count). Importing the wrappers builds nothing."""
    from pio_tpu_torch.ops.kernels import flash_attention as k8
    from pio_tpu_torch.ops.kernels import gather_rows as gr
    from pio_tpu_torch.ops.kernels import packed_matvec as pm
    from pio_tpu_torch.ops.kernels import quantized_scan as qscan
    from pio_tpu_torch.ops.kernels import segment_flush as sf

    return {"quantized_scan": qscan.launches, "segment_flush": sf.launches,
            "segment_flush_stream": sf.launches_stream,
            "normal_equations_fused": sf.launches_fused,
            "gather_rows_stream": gr.launches_stream,
            "gather_rows_resident": gr.launches_resident,
            "packed_matvec": pm.launches,
            "flash_attention": k8.launches}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process, by kernel name."""
    return {name: c.value for name, c in launch_counters().items()}
