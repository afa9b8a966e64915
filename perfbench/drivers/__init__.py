"""Drivers: one kind of work each, named by a traffic mix's ``driver``."""
