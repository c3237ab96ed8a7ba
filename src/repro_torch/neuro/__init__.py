"""The paper's application workload on PyTorch: Hodgkin–Huxley cable cells
in ring networks (Arbor's ring benchmark, NEURON's ringtest), simulated in
bulk-synchronous epochs with the fused HH soma update as the kernel."""
