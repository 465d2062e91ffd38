"""Op units and the kernel wrappers they run on."""
