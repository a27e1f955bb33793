"""portbench: the benchmark of the PyTorch and CUDA port (``ompi_tpu_torch``).

One run is ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  The harness is driven by data: a cell of
``BENCHMARK.json`` names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``); every metric has a reader of its
own (``metrics/<name>.py``) and every cell its correctness limits
(``limits/<cell>.json``).  Nothing here imports JAX or the JAX package.
"""
