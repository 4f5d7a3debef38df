"""The benchmark's harness: cells, traffic, inputs, trace and checks, and the
loader of the parts found by name (loops, checks, layer kinds, event
generators, references, metrics).

Only :mod:`perfbench.harness.port` imports the program under test
(``repro_torch``), inside its functions; everything else here is the
yardstick and imports nothing of it.
"""
