"""Physical constants (canonical WRF: share/module_model_constants.F analog).

Values match the reference model's constants so that discrete solutions are
comparable field-for-field (SURVEY.md §4: allclose-vs-reference contract).
"""

G = 9.81                # gravity [m s-2]
R_D = 287.0             # gas constant, dry air [J kg-1 K-1]
R_V = 461.6             # gas constant, water vapor
CP = 7.0 * R_D / 2.0    # = 1004.5 J kg-1 K-1
CV = CP - R_D
GAMMA = CP / CV         # = 1.4
RCP = R_D / CP
CVPM = -CV / CP
P0 = 1.0e5              # reference pressure [Pa]
T0 = 300.0              # reference potential temperature offset [K]
RVOVRD = R_V / R_D
EP_1 = R_V / R_D - 1.0  # 0.608: virtual temperature factor
EP_2 = R_D / R_V        # 0.622: eps in saturation formulas
XLV = 2.5e6             # latent heat of vaporization [J kg-1]
XLF = 3.50e5            # latent heat of fusion
XLS = XLV + XLF         # sublimation
RHOWATER = 1000.0       # [kg m-3]
RHOSNOW = 100.0
SVP1 = 0.6112           # Bolton saturation vapor pressure coefficients [kPa]
SVP2 = 17.67
SVP3 = 29.65
SVPT0 = 273.15
STBOLT = 5.670373e-8    # Stefan-Boltzmann [W m-2 K-4]
KARMAN = 0.4
SOLAR_CONSTANT = 1361.0  # [W m-2]
PI = 3.141592653589793
DEG2RAD = PI / 180.0
AVOGADRO = 6.02214076e23
MW_AIR = 28.966e-3      # [kg mol-1]
