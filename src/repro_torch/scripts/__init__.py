"""The port's developer scripts, each the counterpart of the JAX package's
``scripts/<name>.py`` and runnable as ``python -m
repro_torch.scripts.<name> [--device cpu]``:

    kernel_support   the backend plan of each (config, backend) pair
    smoke_core       end-to-end accuracy in all three modes
    smoke_ssdmodel   the Workload -> cost path under both cost models
    sweep2           quantization / seed-width / threshold sweep
    sweep_params     event-detection and chaining parameter sweep
    fault_sweep      the seeded fault-injection gate (exit 1 on a
                     violation)
"""
