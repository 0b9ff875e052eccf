"""Device ms a step of the kernels launched under the program's
``ps.optim`` (the optimizer's update, the new weights and their copy into
the module), over the steps of the traced sub-window."""


def read(run):
    p = run.profile
    if p is None or p.t_stop is None or not p.units or not p.range_calls.get("ps.optim"):
        return None
    return 1e3 * p.by_range["ps.optim"] / p.units
