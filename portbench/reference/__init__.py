"""The plain reference of the benchmarked entries: plain PyTorch on dense
pixels, importing nothing of the program.  ``raster`` holds the raster
front-end."""
