"""Node composition layer.

Reference: packages/beacon-node/src/node/nodejs.ts (BeaconNode) and
packages/cli dev command (cli/src/cmds/dev/) for the in-process chain.
"""

from .dev_chain import DevChain  # noqa: F401
