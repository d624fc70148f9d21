from .account import (  # noqa: F401
    Account as EcdsaAccount,
    private_key_to_account,
    pack_signature,
    sign_message,
    unpack_signature,
    verify_message,
)
from .circuits import (  # noqa: F401
    EcdsaVerificationCircuit,
    make_ecdsa_verification_circuit,
    verify_message_circuit,
)
