"""The collective-contract linter over the port's own collectives (port
of `analysis/`).

The reference lowers engine x mode x mesh combos to XLA HLO on a virtual
mesh, maps every collective to the mesh axes it crosses and checks the
contracts the repo claims in prose. The port has no HLO: its engines
issue their collectives one call at a time through `torch.distributed`,
so the linter records what one rank really issues in one step and
checks the same contracts over that record:

  record.py       the counterpart of `hlo.py`: a recorder of the
                  collective calls one rank issues (op, group ranks,
                  dtype, elements, bytes, scope), the one scope seam the
                  hop sites name their hops through, and the fake
                  process group that lets one process play one rank
  collectives.py  every record classified against the mesh: its kind,
                  payload, ring hop or monolithic, and the axes it
                  crosses
  rules.py        the reference's 20 rules (ids, severities, contracts),
                  each checked over the record; the ones with no
                  counterpart in a torch program say why
  lint.py         run any engine x model x mode combo as one rank of its
                  world and run the registry over its step; the module
                  is the CLI (the reference's `tools/hlolint`)
"""
