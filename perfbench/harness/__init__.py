"""The benchmark's harness: cells, traffic, inputs, drivers, trace and checks.

Only :mod:`perfbench.harness.port` imports the program under test
(``repro_torch``); everything else here is the yardstick and imports
nothing of it.
"""
