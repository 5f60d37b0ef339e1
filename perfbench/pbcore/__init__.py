"""The benchmark's general machinery: the files of a cell found by name,
one traffic generator, seeded weights, the drivers of the program's
serving and training entry points, the reading of a device trace and the
comparison with the plain reference."""
