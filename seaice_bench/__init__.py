"""The benchmark of ``climaseaice_jl_tpu_torch`` on NVIDIA cards.

One run measures one cell: ``python3 -m seaice_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  Everything that belongs to one
cell, configuration, traffic mix or per-layer metric sits in a file of its
own, found by its name (:mod:`.registry`): ``cells/<cell>.json`` (with the
cell's limits), ``configs/<config>.json`` with its module
``configs/<config>.py`` and its plain reference ``reference/<config>.py``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
