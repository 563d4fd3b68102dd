"""``W8_roofline`` in the recordings cell, apart so that the wider spread of
that cell's runs sets no bound for the turn cells."""

from benchmark.harness import reader

read = reader("W8_roofline").read
