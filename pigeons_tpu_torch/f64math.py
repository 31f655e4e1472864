"""float64 ``fma``, ``exp``, ``log``, ``log1p``, ``expm1``, ``erfinv``,
``lgamma`` and ``logaddexp`` as plain torch ops, the forms that XLA's CPU
backend evaluates in a float64 run (``Inputs.dtype=float64`` of the JAX
package, under x64). :mod:`.f32math` calls them for float64 tensors.

Read off XLA's CPU code (its LLVM IR and machine code for each op):

* every multiply that feeds an add is a fused multiply-add, as in float32.
  :func:`fma` is ``torch.addcmul`` where that is fused (checked once a
  device type), else :func:`_fma_exact`, an exact emulation: the product
  split into two doubles (Dekker), the sum with ``c`` by TwoSum, the two
  errors added with rounding to odd (their sum's TwoSum error sets the last
  bit) and one last rounded add (Boldo and Melquiond), exact wherever the
  product and the operands lie in the normal range;
* ``exp`` is XLA's own: the argument clamped to [-708.4, 709.8], reduced by
  ``n = floor(x log2(e) + 1/2)`` in two steps of ln 2, a rational form
  ``1 + 2 p / (q - p)`` in the reduced argument, times ``2^n`` as four
  factors; bitwise;
* ``log`` is not XLA's: its CPU code calls the C library's ``log``. On
  glibc (2.28 on) that is the Arm optimized-routines algorithm, and on a CPU
  with FMA its FMA build: a 128-entry table of ``(1/c, log c)``
  (``_LOG_TAB``, glibc's ``__log_data.tab``), ``r = z/c - 1`` fused, a
  degree-5 polynomial, and near 1 a degree-11 one with an exact head.
  :func:`log` is that algorithm with the build's fused multiply-adds;
  bitwise on the sweeps of ``tests/test_torch_dtype.py``;
* ``log1p`` is the Cephes rational form below ``sqrt(2) - 1`` and
  ``log(1 + x)`` above, the float32 structure with double coefficients;
  ``expm1`` is ``exp(x) - 1`` above 1/2 and ``tanh(x/2) (exp(x) + 1)``
  below, with XLA's float64 rational ``tanh`` (no small-argument branch);
  ``erfinv`` is XLA's ``ErfInv64`` (Giles' three double polynomials in
  ``w = -log1p(-x^2)``); ``logaddexp`` is ``jnp.logaddexp``; all bitwise;
* ``lgamma`` is XLA's Lanczos sum in double for ``x >= 0.5`` (NaN below,
  where XLA reflects through the C library's ``sin``), as the float32 form.

XLA's CPU code runs with denormals read as zero: ``log`` of a subnormal is
-inf and its ``sqrt`` 0, as there. The forms
give the same bits on torch's CPU and CUDA backends: every step is one IEEE
operation, none contracted. Gradients: the differentiable entry points of
:mod:`.f32math` apply the same analytic rules in float64.
"""

from __future__ import annotations

import math
import struct

import torch

F64 = torch.float64


def _d(bits: int) -> float:
    """The float64 with IEEE bit pattern ``bits``."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


_scalars: dict = {}


def scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-dim tensor ``v`` of ``dtype`` on ``device``, made once: a new
    one is a copy to the card, which waits for the card's queue."""
    k = (v, dtype, torch.device(device))
    if k not in _scalars:
        _scalars[k] = torch.tensor(v, dtype=dtype, device=device)
    return _scalars[k]


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float64 tensor on ``like``'s device (a number's, through
    :func:`scalar`)."""
    return v.to(F64) if torch.is_tensor(v) else scalar(float(v), F64, like.device)


_SPLIT = 134217729.0  # 2^27 + 1
_MIN_NORMAL = 2.0 ** -1022


def _split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma_exact(a, b, c) -> torch.Tensor:
    p = a * b
    (ah, al), (bh, bl) = _split(a), _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # a * b = p + pe exactly
    sh, sl = _two_sum(c, p)
    t, te = _two_sum(pe, sl)
    # round to odd: an inexact sum becomes its truncation with the last bit set
    bits = t.view(torch.int64)
    odd = ((bits - (te * t < 0).to(torch.int64)) | 1).view(F64)
    out = sh + torch.where(torch.abs(te) > 0, odd, t)
    # non-finite operands or products: the plain expression's IEEE result
    return torch.where(torch.isfinite(out) & torch.isfinite(pe), out, p + c)


_FUSED: dict = {}  # device type -> whether torch.addcmul rounds a * b + c once there


def _addcmul_is_fused(device) -> bool:
    """Whether ``torch.addcmul`` on ``device`` is a fused multiply-add: its
    CPU kernels use the vector FMA and its CUDA kernel is contracted by
    ``nvcc``, but neither is promised, so it is checked once a device type
    against :func:`_fma_exact` on 4,099 cases (of which three a
    single-element call, the scalar path)."""
    if device.type not in _FUSED:
        g = torch.Generator().manual_seed(0)
        a, b, c = (torch.randn(4096, dtype=F64, generator=g) for _ in range(3))
        c = c * torch.exp2(torch.randint(-60, 10, (4096,), generator=g).to(F64))
        ok = torch.equal(torch.addcmul(c.to(device), a.to(device), b.to(device)).cpu(),
                         _fma_exact(a, b, c))
        for i in range(3):
            one = [v[i:i + 1] for v in (a, b, c)]
            ok = ok and torch.equal(
                torch.addcmul(one[2].to(device), one[0].to(device), one[1].to(device)).cpu(),
                _fma_exact(*one))
        _FUSED[device.type] = ok
    return _FUSED[device.type]


def fma(a, b, c) -> torch.Tensor:
    """float64 ``a * b + c`` with a single rounding: ``torch.addcmul`` where
    it is fused (:func:`_addcmul_is_fused`), else :func:`_fma_exact`."""
    like = next(v for v in (a, b, c) if torch.is_tensor(v))
    a, b, c = _t(a, like), _t(b, like), _t(c, like)
    if _addcmul_is_fused(like.device):
        return torch.addcmul(c, a, b).expand(torch.broadcast_shapes(a.shape, b.shape, c.shape))
    return _fma_exact(a, b, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 ``sqrt`` (torch's CPU kernel is not, in about
    one case in 140): ``torch.sqrt`` corrected by its exact remainder
    ``r = x - s^2`` (an exact :func:`fma`): up where ``r`` exceeds ``s`` times
    the ulp above ``s``, down where ``r <= -s`` times the ulp below."""
    # far from 1 the argument is scaled by 2^(-+200) first, so that the
    # remainder's products neither underflow nor overflow (exact: powers of 2)
    tiny, huge = x < 2.0 ** -900, x > 2.0 ** 900
    xs = torch.where(tiny, x * 2.0 ** 200, torch.where(huge, x * 2.0 ** -200, x))
    s = torch.sqrt(xs)
    r = fma(-s, s, xs)
    s_up = torch.nextafter(s, torch.full_like(s, math.inf))
    s_dn = torch.nextafter(s, torch.zeros_like(s))
    out = torch.where(r > s * (s_up - s), s_up, torch.where(r <= -(s * (s - s_dn)), s_dn, s))
    out = torch.where(tiny, out * 2.0 ** -100, torch.where(huge, out * 2.0 ** 100, out))
    out = torch.where(torch.isfinite(x) & (x > 0), out, torch.sqrt(x))
    return torch.where((x >= 0) & (x < _MIN_NORMAL), torch.zeros_like(out), out)  # subnormal: 0


# XLA's float64 exp
_EXP_HI, _EXP_LO = _d(0x40862E42FEFA39EF), _d(0xC086232BDD7ABCD2)
_LOG2E = _d(0x3FF71547652B82FE)
_EXP_C1, _EXP_C2 = _d(0x3FE62E4000000000), _d(0x3EB7F7D1CF79ABCA)
_EXP_P = (_d(0x3F2089CDD5E44BE8), _d(0x3F9F06D10CCA2C7E))
_EXP_Q = (_d(0x3EC92EB6BC365FA0), _d(0x3F64AE39B508B6C0), _d(0x3FCD17099887E074))
_ONE_BITS = 0x3FF0000000000000


def exp(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma(xc, _LOG2E, 0.5))
    g = fma(-n, _EXP_C1, xc)
    g = fma(-n, _EXP_C2, g)
    g2 = g * g
    p = fma(fma(g2, _EXP_P[0], _EXP_P[1]), g2, 1.0) * g
    q = fma(fma(fma(g2, _EXP_Q[0], _EXP_Q[1]), g2, _EXP_Q[2]), g2, 2.0)
    e = (p / (q - p)) * 2.0 + 1.0
    ni = torch.nan_to_num(n, nan=0.0).clamp(-2099.0, 2099.0).to(torch.int64)
    b = ni >> 2
    s1 = ((b << 52) + _ONE_BITS).view(F64)
    s2 = (((ni - 3 * b) << 52) + _ONE_BITS).view(F64)
    out = e * s1 * s1 * s1 * s2
    out = torch.where(x < _EXP_LO, torch.zeros_like(out), out)
    return torch.where(x > _EXP_HI, torch.full_like(out, math.inf), out)


# glibc's log (Arm optimized routines), FMA build: ln 2 in two parts, the
# main polynomial A, the near-one polynomial B (B[0] = -1/2) and the table of
# (1/c, log c) for the 128 subintervals of [0x1.6p-1, 0x1.6p0)
_LN2HI = float.fromhex("0x1.62e42fefa3800p-1")
_LN2LO = float.fromhex("0x1.ef35793c76730p-45")
_LOG_A = [float.fromhex(h) for h in (
    "-0x1.0000000000001p-1", "0x1.555555551305bp-2", "-0x1.fffffffeb4590p-3",
    "0x1.999b324f10111p-3", "-0x1.55575e506c89fp-3")]
_LOG_B = [float.fromhex(h) for h in (
    "-0x1.0000000000000p-1", "0x1.5555555555577p-2", "-0x1.ffffffffffdcbp-3",
    "0x1.999999995dd0cp-3", "-0x1.55555556745a7p-3", "0x1.24924a344de30p-3",
    "-0x1.fffffa4423d65p-4", "0x1.c7184282ad6cap-4", "-0x1.999eb43b068ffp-4",
    "0x1.78182f7afd085p-4", "-0x1.5521375d145cdp-4")]
_LOG_TAB = (
    0x3FF734F0C3E0DE9F, 0xBFD7CC7F79E69000, 0x3FF713786A2CE91F, 0xBFD76FEEC20D0000,
    0x3FF6F26008FAB5A0, 0xBFD713E31351E000, 0x3FF6D1A61F138C7D, 0xBFD6B85B38287800,
    0x3FF6B1490BC5B4D1, 0xBFD65D5590807800, 0x3FF69147332F0CBA, 0xBFD602D076180000,
    0x3FF6719F18224223, 0xBFD5A8CA86909000, 0x3FF6524F99A51ED9, 0xBFD54F4356035000,
    0x3FF63356AA8F24C4, 0xBFD4F637C36B4000, 0x3FF614B36B9DDC14, 0xBFD49DA7FDA85000,
    0x3FF5F66452C65C4C, 0xBFD445923989A800, 0x3FF5D867B5912C4F, 0xBFD3EDF439B0B800,
    0x3FF5BABCCB5B90DE, 0xBFD396CE448F7000, 0x3FF59D61F2D91A78, 0xBFD3401E17BDA000,
    0x3FF5805612465687, 0xBFD2E9E2EF468000, 0x3FF56397CEE76BD3, 0xBFD2941B3830E000,
    0x3FF54725E2A77F93, 0xBFD23EC58CDA8800, 0x3FF52AFF42064583, 0xBFD1E9E129279000,
    0x3FF50F22DBB2BDDF, 0xBFD1956D2B48F800, 0x3FF4F38F4734DED7, 0xBFD141679AB9F800,
    0x3FF4D843CFDE2840, 0xBFD0EDD094EF9800, 0x3FF4BD3EC078A3C8, 0xBFD09AA518DB1000,
    0x3FF4A27FC3E0258A, 0xBFD047E65263B800, 0x3FF4880524D48434, 0xBFCFEB224586F000,
    0x3FF46DCE1B192D0B, 0xBFCF474A7517B000, 0x3FF453D9D3391854, 0xBFCEA4443D103000,
    0x3FF43A2744B4845A, 0xBFCE020D44E9B000, 0x3FF420B54115F8FB, 0xBFCD60A22977F000,
    0x3FF40782DA3EF4B1, 0xBFCCC00104959000, 0x3FF3EE8F5D57FE8F, 0xBFCC202956891000,
    0x3FF3D5D9A00B4CE9, 0xBFCB81178D811000, 0x3FF3BD60C010C12B, 0xBFCAE2C9CCD3D000,
    0x3FF3A5242B75DAB8, 0xBFCA45402E129000, 0x3FF38D22CD9FD002, 0xBFC9A877681DF000,
    0x3FF3755BC5847A1C, 0xBFC90C6D69483000, 0x3FF35DCE49AD36E2, 0xBFC87120A645C000,
    0x3FF34679984DD440, 0xBFC7D68FB4143000, 0x3FF32F5CCEFFCB24, 0xBFC73CB83C627000,
    0x3FF3187775A10D49, 0xBFC6A39A9B376000, 0x3FF301C8373E3990, 0xBFC60B3154B7A000,
    0x3FF2EB4EBB95F841, 0xBFC5737D76243000, 0x3FF2D50A0219A9D1, 0xBFC4DC7B8FC23000,
    0x3FF2BEF9A8B7FD2A, 0xBFC4462C51D20000, 0x3FF2A91C7A0C1BAB, 0xBFC3B08ABC830000,
    0x3FF293726014B530, 0xBFC31B996B490000, 0x3FF27DFA5757A1F5, 0xBFC2875490A44000,
    0x3FF268B39B1D3BBF, 0xBFC1F3B9F879A000, 0x3FF2539D838FF5BD, 0xBFC160C8252CA000,
    0x3FF23EB7AAC9083B, 0xBFC0CE7F57F72000, 0x3FF22A012BA940B6, 0xBFC03CDC49FEA000,
    0x3FF2157996CC4132, 0xBFBF57BDBC4B8000, 0x3FF201201DD2FC9B, 0xBFBE370896404000,
    0x3FF1ECF4494D480B, 0xBFBD17983EF94000, 0x3FF1D8F5528F6569, 0xBFBBF9674ED8A000,
    0x3FF1C52311577E7C, 0xBFBADC79202F6000, 0x3FF1B17C74CB26E9, 0xBFB9C0C3E7288000,
    0x3FF19E010C2C1AB6, 0xBFB8A646B372C000, 0x3FF18AB07BB670BD, 0xBFB78D01B3AC0000,
    0x3FF1778A25EFBCB6, 0xBFB674F145380000, 0x3FF1648D354C31DA, 0xBFB55E0E6D878000,
    0x3FF151B990275FDD, 0xBFB4485CDEA1E000, 0x3FF13F0EA432D24C, 0xBFB333D94D6AA000,
    0x3FF12C8B7210F9DA, 0xBFB22079F8C56000, 0x3FF11A3028ECB531, 0xBFB10E4698622000,
    0x3FF107FBDA8434AF, 0xBFAFFA6C6AD20000, 0x3FF0F5EE0F4E6BB3, 0xBFADDA8D4A774000,
    0x3FF0E4065D2A9FCE, 0xBFABBCECE4850000, 0x3FF0D244632CA521, 0xBFA9A1894012C000,
    0x3FF0C0A77CE2981A, 0xBFA788583302C000, 0x3FF0AF2F83C636D1, 0xBFA5715E67D68000,
    0x3FF09DDB98A01339, 0xBFA35C8A49658000, 0x3FF08CABAF52E7DF, 0xBFA149E364154000,
    0x3FF07B9F2F4E28FB, 0xBF9E72C082EB8000, 0x3FF06AB58C358F19, 0xBF9A55F152528000,
    0x3FF059EEA5ECF92C, 0xBF963D62CF818000, 0x3FF04949CDD12C90, 0xBF9228FB8CAA0000,
    0x3FF038C6C6F0ADA9, 0xBF8C317B20F90000, 0x3FF02865137932A9, 0xBF8419355DAA0000,
    0x3FF0182427EA7348, 0xBF781203C2EC0000, 0x3FF008040614B195, 0xBF60040979240000,
    0x3FEFE01FF726FA1A, 0x3F6FEFF384900000, 0x3FEFA11CC261EA74, 0x3F87DC41353D0000,
    0x3FEF6310B081992E, 0x3F93CEA3C4C28000, 0x3FEF25F63CEEADCD, 0x3F9B9FC114890000,
    0x3FEEE9C8039113E7, 0x3FA1B0D8CE110000, 0x3FEEAE8078CBB1AB, 0x3FA58A5BD001C000,
    0x3FEE741AA29D0C9B, 0x3FA95C8340D88000, 0x3FEE3A91830A99B5, 0x3FAD276AEF578000,
    0x3FEE01E009609A56, 0x3FB07598E598C000, 0x3FEDCA01E577BB98, 0x3FB253F5E30D2000,
    0x3FED92F20B7C9103, 0x3FB42EDD8B380000, 0x3FED5CAC66FB5CCE, 0x3FB606598757C000,
    0x3FED272CAA5EDE9D, 0x3FB7DA76356A0000, 0x3FECF26E3E6B2CCD, 0x3FB9AB434E1C6000,
    0x3FECBE6DA2A77902, 0x3FBB78C7BB0D6000, 0x3FEC8B266D37086D, 0x3FBD431332E72000,
    0x3FEC5894BD5D5804, 0x3FBF0A3171DE6000, 0x3FEC26B533BB9F8C, 0x3FC067152B914000,
    0x3FEBF583EEECE73F, 0x3FC147858292B000, 0x3FEBC4FD75DB96C1, 0x3FC2266ECDCA3000,
    0x3FEB951E0C864A28, 0x3FC303D7A6C55000, 0x3FEB65E2C5EF3E2C, 0x3FC3DFC33C331000,
    0x3FEB374867C9888B, 0x3FC4BA366B7A8000, 0x3FEB094B211D304A, 0x3FC5933928D1F000,
    0x3FEADBE885F2EF7E, 0x3FC66ACD2418F000, 0x3FEAAF1D31603DA2, 0x3FC740F8EC669000,
    0x3FEA82E63FD358A7, 0x3FC815C0F51AF000, 0x3FEA5740EF09738B, 0x3FC8E92954F68000,
    0x3FEA2C2A90AB4B27, 0x3FC9BB3602F84000, 0x3FEA01A01393F2D1, 0x3FCA8BED1C2C0000,
    0x3FE9D79F24DB3C1B, 0x3FCB5B515C01D000, 0x3FE9AE2505C7B190, 0x3FCC2967CCBCC000,
    0x3FE9852EF297CE2F, 0x3FCCF635D5486000, 0x3FE95CBAEEA44B75, 0x3FCDC1BD3446C000,
    0x3FE934C69DE74838, 0x3FCE8C01B8CFE000, 0x3FE90D4F2F6752E6, 0x3FCF5509C0179000,
    0x3FE8E6528EFFD79D, 0x3FD00E6C121FB800, 0x3FE8BFCE9FCC007C, 0x3FD071B80E93D000,
    0x3FE899C0DABEC30E, 0x3FD0D46B9E867000, 0x3FE87427AA2317FB, 0x3FD13687334BD000,
    0x3FE84F00ACB39A08, 0x3FD1980D67234800, 0x3FE82A49E8653E55, 0x3FD1F8FFE0CC8000,
    0x3FE8060195F40260, 0x3FD2595FD7636800, 0x3FE7E22563E0A329, 0x3FD2B9300914A800,
    0x3FE7BEB377DCB5AD, 0x3FD3187210436000, 0x3FE79BAA679725C2, 0x3FD377266DEC1800,
    0x3FE77907F2170657, 0x3FD3D54FFBAF3000, 0x3FE756CADBD6130C, 0x3FD432EEE32FE000,
)
_LOG_NEAR_LO = struct.unpack("<q", struct.pack("<d", 1.0 - 2.0 ** -4))[0]
_LOG_NEAR_HI = struct.unpack("<q", struct.pack("<d", 1.0 + float.fromhex("0x1.09p-4")))[0]
_LOG_OFF = 0x3FE6000000000000
_tab_cache: dict = {}


def _log_tab(device) -> torch.Tensor:
    if device not in _tab_cache:
        bits = torch.tensor([b - (1 << 64) if b >= 1 << 63 else b for b in _LOG_TAB],
                            dtype=torch.int64)
        _tab_cache[device] = bits.view(F64).reshape(128, 2).to(device)
    return _tab_cache[device]


def log(x: torch.Tensor) -> torch.Tensor:
    # near 1: a polynomial in r = x - 1 with an exact head r - r^2 / 2
    r = x - 1.0
    r2 = r * r
    r3 = r * r2
    B = _LOG_B
    inner = fma(r3, B[10], fma(r2, B[9], fma(r, B[8], B[7])))
    inner = fma(r3, inner, fma(r2, B[6], fma(r, B[5], B[4])))
    poly = fma(r3, inner, fma(r2, B[3], fma(r, B[2], B[1])))
    w = r * 134217728.0
    rhi = (r + w) - w
    rlo = r - rhi
    w = (rhi * rhi) * B[0]
    hi = r + w
    lo = (r - hi) + w
    lo = fma(B[0] * rlo, rhi + r, lo)
    near = fma(r3, poly, lo) + hi

    # elsewhere: x = 2^k z with z in [0x1.6p-1, 0x1.6p0), log c from the table
    ix = x.view(torch.int64)
    tmp = ix - _LOG_OFF
    i = (tmp >> 45) & 127
    k = tmp >> 52
    z = (ix - (k << 52)).view(F64)
    tab = _log_tab(x.device)
    invc, logc = tab[i, 0], tab[i, 1]
    r = fma(z, invc, -1.0)
    kd = k.to(F64)
    w = fma(kd, _LN2HI, logc)
    hi = w + r
    lo = fma(kd, _LN2LO, (w - hi) + r)
    r2 = r * r
    A = _LOG_A
    poly = fma(r2, fma(r, A[4], A[3]), fma(r, A[2], A[1]))
    main = fma(r * r2, poly, fma(r2, A[0], lo)) + hi

    bits = x.view(torch.int64)
    out = torch.where((bits >= _LOG_NEAR_LO) & (bits < _LOG_NEAR_HI), near, main)
    out = torch.where(x == 1.0, torch.zeros_like(out), out)
    # XLA's CPU code reads subnormal inputs as 0 (denormals-are-zero)
    out = torch.where(x < _MIN_NORMAL, torch.full_like(out, -math.inf), out)
    out = torch.where(x == math.inf, x, out)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(out, math.nan), out)


# Cephes log1p, double coefficients (XLA's EmitLog1p)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    p = fma(x, _LOG1P_NUM[0], _LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        p = fma(p, x, c)
    q = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        q = fma(q, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log(x + 1.0))


# XLA's float64 tanh: odd rational form in the clamped argument
_TANH_CLAMP = _d(0x4031B6D58F246197)
_TANH_P = tuple(_d(b) for b in (
    0x3B3F9F82E5D782DF, 0x3C2C3C836C04B4C8, 0x3CEC3379F905E662, 0x3D929AFF6C8EDD96,
    0x3E2525A389DCE7C2, 0x3EA708819BE51CD9, 0x3F18996F4026A7FA, 0x3F787F80B957ED00,
    0x3FC36FBA9B450E5A)) + (1.0,)
_TANH_Q = tuple(_d(b) for b in (
    0x3BBE8630CF903250, 0x3C90AABCA9A5FEA0, 0x3D4232981AA2BBA8, 0x3DDEE2F015EA8065,
    0x3E681F1947C52304, 0x3EE26C82AB46D140, 0x3F4B2E7C4D488C04, 0x3FA1998830265B50,
    0x3FDF0D32A2F7DC79)) + (1.0,)


def _tanh(h: torch.Tensor) -> torch.Tensor:
    hc = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    z = hc * hc
    p = fma(z, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = fma(z, p, c)
    q = fma(z, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = fma(z, q, c)
    t = (hc * p) / q
    return torch.where(torch.abs(h) >= 20.0, torch.copysign(torch.ones_like(h), h), t)


def expm1(x: torch.Tensor) -> torch.Tensor:
    e = exp(x)
    h = x * 0.5
    out = torch.where(torch.abs(x) > 0.5, e - 1.0, _tanh(h) * (e + 1.0))
    return torch.where(h == 0, x, out)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    delta = a - b
    out = torch.maximum(a, b) + log1p(exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), a + b, out)


# XLA's ErfInv64: Giles' double-precision polynomials for w < 6.25, w < 16
# and above, in w - 3.125, sqrt(w) - 3.25 and sqrt(w) - 5
_ERFINV_LT6 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -log1p(x * -x)
    lt6, lt16 = w < 6.25, w < 16.0
    sqrt_w = sqrt(w)
    w = torch.where(lt6, w - 3.125, sqrt_w - torch.where(lt16, 3.25, 5.0))

    def coef(i):
        c = torch.full_like(x, _ERFINV_LT6[i])
        if i < 19:
            c = torch.where(lt6, c, _ERFINV_LT16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV_GE16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = fma(p, w, coef(i))
    for i in range(17, 19):
        p = torch.where(lt16, fma(p, w, coef(i)), p)
    for i in range(19, 23):
        p = torch.where(lt6, fma(p, w, coef(i)), p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


# XLA's lgamma: Lanczos approximation with g = 7 and nine terms
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)
_LOG_SQRT_2PI = (math.log(2.0) + math.log(math.pi)) / 2.0


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """For ``x >= 0.5``; NaN below (the reflection is not reproduced)."""
    z = x - 1.0
    s = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        # a tensor numerator: torch's scalar / tensor multiplies by a reciprocal
        s = s + torch.full_like(x, c) / (z + float(i + 1))  # XLA folds the index and the 1
    t = z + 7.5
    log_t = log1p(z * (1.0 / 7.5)) + math.log(7.5)
    a = (z + 0.5) - t / log_t
    out = fma(a, log_t, _LOG_SQRT_2PI) + log(s)
    return torch.where(x >= 0.5, out, torch.full_like(out, math.nan))
