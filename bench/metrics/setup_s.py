"""setup_s: seconds from process start until the program is ready to serve
(weights drawn and packed, kernels loaded, the cell's shapes run once)."""


def read(record):
    return record.setup_s
