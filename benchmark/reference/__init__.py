"""The benchmark's yardstick: frozen copies, the plain reference and the
work counts."""
