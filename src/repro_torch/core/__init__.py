"""RaanA core in PyTorch: practical RHT, code packing, RaBitQ-H, tricks and
the deployable ``QuantizedLinear``."""
