"""The benchmark harness of ``paddle_tpu_torch``: one run of one cell.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; the harness finds everything else by
those names: ``configs/<config>.json`` (the model's sizes),
``traffic/<traffic>.json`` (the mix and the deployment that serves
it), ``limits/<cell>.json`` (the limits of the output check),
``metrics/<metric>.py`` (one reader a per-layer metric) and
``kernels/<metric>/*.txt`` (the device kernels a roofline counts).
"""
