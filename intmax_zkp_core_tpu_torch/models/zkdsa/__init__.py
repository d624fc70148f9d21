from .account import Account, Address, private_key_to_account  # noqa: F401
from .circuits import SimpleSignatureCircuit, SimpleSignaturePublicInputs, make_simple_signature_circuit  # noqa: F401
