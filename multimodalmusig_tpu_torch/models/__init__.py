"""MMCTM and the logistic-normal CTM machinery it is built on."""
