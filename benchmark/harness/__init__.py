"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, makes its inputs from the seed, drives the program's
receiver through the cell's traffic, times it, traces it on request and
checks the responses against ``benchmark/reference``."""
