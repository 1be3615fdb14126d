"""The benchmark's harness: registry, traffic, drivers, spans and trace reading."""
