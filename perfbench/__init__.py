"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic
mix, check or metric is a file of its own, found by its name:

* ``configs/<config>.json``    the model as it is run, with its source;
* ``traffic/<traffic>.json``   the mix one general generator reads, and
                               the runner that drives it;
* ``checks/<cell>.json``       the steps the plain reference follows and
                               the limit of each number compared;
* ``end_to_end/<metric>.py``   a reader of the timed window;
* ``metrics/<metric>.py``      a reader of the traced window;
* ``runners/<runner>.py``      the entry a traffic mix drives;
* ``reference/<family>.py``    the plain PyTorch model of a family.
"""
