"""The benchmark's harness: it finds a cell's pieces by name, drives the
system under test, reads the metrics and decides ``correct``."""
