"""Tiny configurations and traffic mixes of the tests: the cells' own
settings with the widths cut so that a run takes seconds on the CPU."""

from portbench import spec

TINY_SIZES = {"dim_hidden": 16, "s_rounds": 2, "t_rounds": 2, "dim_mlp": 8}


def config(name: str) -> dict:
    bench = spec.benchmark()
    return dict(spec.config(bench, name), **TINY_SIZES)


def random_traffic(**kw) -> dict:
    t = dict(family="random", num_inputs=6, num_gates=30, num_tt_pairs=12, train_pool=8,
             train_entries=32, val_pool=4, val_entries=8, batch_size=4, dp=1, steps_per_call=4)
    t.update(kw)
    return t


def layered_traffic() -> dict:
    return dict(family="layered", width=16, depth=12, num_tt_pairs=20, train_pool=2,
                train_entries=8, val_pool=0, val_entries=0, batch_size=1, dp=1, steps_per_call=8)


def cell(workload: str, config_name: str, traffic: dict):
    from portbench import cell as cell_mod

    return cell_mod.Cell(workload, config(config_name), traffic, spec.limits(workload),
                         device="cpu")
