"""Host-side geospatial I/O and projection math of the port (numpy only; its
own copies of ``sifsr_tpu/geo``): the GeoTIFF reader and writer (``tiff``),
the HDF4 / HDF-EOS reader and writer for MODIS granules (``hdf4``), the MODIS
sinusoidal / UTM transforms (``projection``) and raster reprojection
(``warp``)."""

from sifsr_tpu_torch.geo.tiff import GeoTiff, read_geotiff, write_geotiff

__all__ = ["GeoTiff", "read_geotiff", "write_geotiff"]
