from hspmv.tune.model import reference_gpu_params, plan_layout, LayoutPlan  # noqa: F401
