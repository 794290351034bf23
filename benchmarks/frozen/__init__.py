"""Frozen copies of the program's generator, reader, trace arithmetic and
kernel counts: the benchmark's yardstick, which imports nothing of the
program."""
