"""The paper's contribution, on one GPU (the reference's ``repro.core``):

  manifest    — environment encapsulation + late host binding (the image)
  bootstrap   — the PMIx-analogue wire-up on ``torch.distributed``
  attest      — the step's dispatched program, fingerprinted and read for
                transport findings (the reference parses compiled HLO)
  inspector   — the reference's HLO transport inspector, copied for the
                data types the audit layer reads
  verify      — dual-environment statistical comparison
  diagnostics — findings -> CI gate
  registry    — --arch resolution over the assigned architecture pool
"""
