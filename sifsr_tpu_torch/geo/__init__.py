"""Host-side geospatial I/O of the port: the numpy-only GeoTIFF reader and
writer (the port's own copy of ``sifsr_tpu/geo/tiff.py``)."""

from sifsr_tpu_torch.geo.tiff import GeoTiff, read_geotiff, write_geotiff

__all__ = ["GeoTiff", "read_geotiff", "write_geotiff"]
