"""The benchmark's yardstick and the open loop that drives the program:
traffic, the comparison, the roofline arithmetic, the readings and the
run of one cell (each model family's widths, weights and reference are
under ``portbench/families``)."""
