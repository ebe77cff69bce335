"""Map projection math: MODIS sinusoidal and UTM (Transverse Mercator).

The port's own copy of ``sifsr_tpu/geo/projection.py`` (numpy only).

Replaces the reference's gdalwarp/PROJ dependency for the two CRSs the
pipeline actually uses (model_perf_aster_formatds.py:162, 312-317):

- MODIS sinusoidal on the authalic sphere R = 6371007.181 m
  ("+proj=sinu +R=6371007.181 +nadgrids=@null"): x = R·λ·cos(φ), y = R·φ.
  The +nadgrids=@null pipeline treats the spherical latitudes as WGS84
  latitudes directly (no datum shift) — reproduced here.
- UTM on WGS84 (EPSG:326xx / 327xx) via the Karney/Krüger 6th-order series —
  sub-millimetre accuracy within UTM zones, far below the 231 m pixels.

All functions are vectorised over numpy arrays (radians internally, degrees
at the API boundary, matching PROJ conventions).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "MODIS_SPHERE_RADIUS",
    "sinusoidal_to_lonlat",
    "lonlat_to_sinusoidal",
    "lonlat_to_utm",
    "utm_to_lonlat",
    "sinusoidal_to_utm",
    "utm_to_sinusoidal",
    "utm_epsg_info",
]

MODIS_SPHERE_RADIUS = 6371007.181

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2.0 - _F)

# Krüger series in the third flattening n
_N = _F / (2.0 - _F)
_N2, _N3, _N4, _N5, _N6 = _N**2, _N**3, _N**4, _N**5, _N**6
# rectifying radius
_A1 = _A / (1 + _N) * (1 + _N2 / 4 + _N4 / 64 + _N6 / 256)
# forward coefficients alpha
_ALPHA = np.array([
    _N / 2 - 2 * _N2 / 3 + 5 * _N3 / 16 + 41 * _N4 / 180 - 127 * _N5 / 288 + 7891 * _N6 / 37800,
    13 * _N2 / 48 - 3 * _N3 / 5 + 557 * _N4 / 1440 + 281 * _N5 / 630 - 1983433 * _N6 / 1935360,
    61 * _N3 / 240 - 103 * _N4 / 140 + 15061 * _N5 / 26880 + 167603 * _N6 / 181440,
    49561 * _N4 / 161280 - 179 * _N5 / 168 + 6601661 * _N6 / 7257600,
    34729 * _N5 / 80640 - 3418889 * _N6 / 1995840,
    212378941 * _N6 / 319334400,
])
# inverse coefficients beta
_BETA = np.array([
    _N / 2 - 2 * _N2 / 3 - 37 * _N3 / 96 + _N4 / 360 + 81 * _N5 / 512 - 96199 * _N6 / 604800,
    _N2 / 48 + _N3 / 15 - 437 * _N4 / 1440 + 46 * _N5 / 105 - 1118711 * _N6 / 3870720,
    17 * _N3 / 480 - 37 * _N4 / 840 - 209 * _N5 / 4480 + 5569 * _N6 / 90720,
    4397 * _N4 / 161280 - 11 * _N5 / 504 - 830251 * _N6 / 7257600,
    4583 * _N5 / 161280 - 108847 * _N6 / 3991680,
    20648693 * _N6 / 638668800,
])


def sinusoidal_to_lonlat(x, y, radius: float = MODIS_SPHERE_RADIUS):
    """Sinusoidal metres -> (lon, lat) degrees."""
    lat = np.asarray(y) / radius
    lon = np.asarray(x) / (radius * np.cos(lat))
    return np.degrees(lon), np.degrees(lat)


def lonlat_to_sinusoidal(lon, lat, radius: float = MODIS_SPHERE_RADIUS):
    """(lon, lat) degrees -> sinusoidal metres."""
    lat_r = np.radians(np.asarray(lat))
    lon_r = np.radians(np.asarray(lon))
    return radius * lon_r * np.cos(lat_r), radius * lat_r


def utm_epsg_info(epsg: int) -> tuple[float, bool]:
    """EPSG 326xx/327xx -> (central meridian degrees, is_south)."""
    if 32601 <= epsg <= 32660:
        zone, south = epsg - 32600, False
    elif 32701 <= epsg <= 32760:
        zone, south = epsg - 32700, True
    else:
        raise ValueError(f"not a UTM EPSG code: {epsg}")
    return float(zone * 6 - 183), south


def lonlat_to_utm(lon, lat, epsg: int):
    """(lon, lat) degrees on WGS84 -> UTM easting/northing for ``epsg``."""
    lon0, south = utm_epsg_info(epsg)
    lat_r = np.radians(np.asarray(lat, np.float64))
    dlon = np.radians(np.asarray(lon, np.float64) - lon0)

    # conformal latitude
    e = np.sqrt(_E2)
    t = np.sinh(
        np.arctanh(np.sin(lat_r)) - e * np.arctanh(e * np.sin(lat_r))
    )
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arcsinh(np.sin(dlon) / np.hypot(t, np.cos(dlon)))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        xi = xi + _ALPHA[j] * np.sin(2 * (j + 1) * xi_p) * np.cosh(2 * (j + 1) * eta_p)
        eta = eta + _ALPHA[j] * np.cos(2 * (j + 1) * xi_p) * np.sinh(2 * (j + 1) * eta_p)

    easting = _K0 * _A1 * eta + 500000.0
    northing = _K0 * _A1 * xi + (10000000.0 if south else 0.0)
    return easting, northing


def utm_to_lonlat(easting, northing, epsg: int):
    """UTM easting/northing -> (lon, lat) degrees on WGS84."""
    lon0, south = utm_epsg_info(epsg)
    xi = (np.asarray(northing, np.float64) - (10000000.0 if south else 0.0)) / (_K0 * _A1)
    eta = (np.asarray(easting, np.float64) - 500000.0) / (_K0 * _A1)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        xi_p = xi_p - _BETA[j] * np.sin(2 * (j + 1) * xi) * np.cosh(2 * (j + 1) * eta)
        eta_p = eta_p - _BETA[j] * np.cos(2 * (j + 1) * xi) * np.sinh(2 * (j + 1) * eta)

    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))  # conformal latitude
    lon = lon0 + np.degrees(np.arctan2(np.sinh(eta_p), np.cos(xi_p)))

    # iterate geodetic latitude from conformal latitude
    e = np.sqrt(_E2)
    lat_r = chi.copy()
    for _ in range(6):
        t = np.sinh(np.arctanh(np.sin(chi)) + e * np.arctanh(e * np.sin(lat_r)))
        lat_r = np.arctan(t)
    return lon, np.degrees(lat_r)


def sinusoidal_to_utm(x, y, epsg: int):
    lon, lat = sinusoidal_to_lonlat(x, y)
    return lonlat_to_utm(lon, lat, epsg)


def utm_to_sinusoidal(easting, northing, epsg: int):
    lon, lat = utm_to_lonlat(easting, northing, epsg)
    return lonlat_to_sinusoidal(lon, lat)
