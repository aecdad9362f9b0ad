"""Fixed key material for the smoke run, KAT vectors and tests (the same
primes as ``pailliercryptolib_python_tpu/utils/fixtures.py``).  Fixed
keys are public by definition: not for production use."""

P_1024 = int(
    "12211591599633902543123744145826047141229515915093416534457555434712"
    "92184800130878281361026443386266748018344990604263717038687164570723"
    "11237945964278168911750233706418937331893538475548835863866360604279"
    "73134316618560186659198427100752173458812509683215874149843719309963"
    "1096618971155535533063932776905496443")

Q_1024 = int(
    "16043601091811645291044177494349116409923190569830433191817031694259"
    "67873365178981399454270746358624760934173825754043957811051826146163"
    "91057319509654451547322050379082333141093785577841910964589402968890"
    "60647324321370279584152274347055733649335006946059899146144769589453"
    "9668559897537654548876222765070964737")

P_128 = 193651076660717054826992068826380876453
Q_128 = 258036492587696595507938840934117552961


def fixed_key_ints(n_length: int = 2048, enable_DJN: bool = True) -> dict:
    """Deterministic key material (2048 or 256 bits; other sizes are
    generated fresh)."""
    if n_length == 2048:
        p, q = P_1024, Q_1024
    elif n_length == 256:
        p, q = P_128, Q_128
    else:
        from ..models.paillier import generate_key_ints
        return generate_key_ints(n_length, enable_DJN)
    n = p * q
    out = {"n": n, "p": p, "q": q, "enable_DJN": enable_DJN,
           "bits": n.bit_length()}
    if enable_DJN:
        x = (n // 7) | 1            # deterministic DJN base
        h = (-(x * x)) % n
        out["hs"] = pow(h, n, n * n)
        out["randbits"] = n_length // 2
    return out
