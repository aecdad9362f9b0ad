"""portbench: the benchmark of ``pailliercryptolib_python_tpu_torch``.

Run one cell once with ``python3 portbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``workloads/<traffic>.json``,
each request kind the mix names in ``kinds/<op>.py`` and each metric's
reader in ``metrics/<metric>.py``.
"""
