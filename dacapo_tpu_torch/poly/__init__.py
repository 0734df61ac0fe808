"""HE-CNN ops library (copy of dacapo_tpu/poly): MPCB packing, activation
polynomials, layer wrappers."""
