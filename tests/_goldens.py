"""Where each program's golden plan lives: the reference's programs in
``goldens/plans/`` (the JAX package's corpus, held to exactly its
programs), the port's own (``PORT_ONLY``) in ``goldens/port_plans/``."""
import pathlib

from repro_torch.core.programs import PORT_ONLY

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
GOLDEN_DIR = GOLDENS / "plans"
PORT_GOLDEN_DIR = GOLDENS / "port_plans"


def golden_path(name: str) -> pathlib.Path:
    """The golden plan of the program ``name``."""
    return (PORT_GOLDEN_DIR if name in PORT_ONLY else GOLDEN_DIR) \
        / f"{name}.json"
