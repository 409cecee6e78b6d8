"""Image I/O for the port: the TIFF codec, PNG decode without PIL, directory
listing. Copies of the JAX package's ``io/`` pieces the directory path needs
(the port may not import that package); the PNG decoder is built into the
port's own build directory."""
